"""Port parity: the rank meshes (``repro_torch.launch.mesh``) and the
logical sharding rules (``repro_torch.dist.sharding``) against the JAX
package's, and the coordinate-shard layout against JAX's ``_to_view``.

``logical_spec`` is held entry for entry against JAX's on abstract JAX
meshes of the same shapes (no devices needed); the port's ``Mesh`` needs
no process group for shapes, worker counts and rules."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.dist import sharding as tsharding
from repro_torch.dist.sharded import n_coord_shards
from repro_torch.launch import mesh as tmesh

NAMES = sorted(tsharding.DEFAULT_RULES) + ["unknown_axis", None]


def _jax_mesh(shape, axes):
    from jax.sharding import AbstractMesh
    return AbstractMesh(tuple(shape), tuple(axes))


@pytest.mark.parametrize("n,want", [(1, (1, 1)), (2, (2, 1)), (3, (3, 1)),
                                    (4, (2, 2)), (5, (5, 1)), (6, (3, 2)),
                                    (7, (7, 1)), (8, (2, 4))])
def test_host_mesh_shapes(n, want, monkeypatch):
    from repro.launch.mesh import _model_factor as jax_model_factor
    assert tmesh._model_factor(n) == jax_model_factor(n)
    monkeypatch.setattr(tmesh, "world_size", lambda: 8)
    m = tmesh.make_host_mesh(n)
    assert m.axis_sizes == want and m.axis_names == ("data", "model")
    assert tmesh.worker_count(m) == want[0]
    assert n_coord_shards(m) == n
    assert tmesh.make_debug_mesh(n) == m


def test_host_mesh_defaults_to_the_world_and_raises_beyond_it(monkeypatch):
    assert tmesh.make_host_mesh().axis_sizes == (1, 1)      # no group: 1
    with pytest.raises(ValueError, match="asked for 2 ranks but only 1"):
        tmesh.make_host_mesh(2)
    monkeypatch.setattr(tmesh, "world_size", lambda: 4)
    assert tmesh.make_host_mesh().axis_sizes == (2, 2)
    with pytest.raises(ValueError, match="asked for 8 ranks but only 4"):
        tmesh.make_host_mesh(8)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes(multi_pod, monkeypatch):
    need = 512 if multi_pod else 256
    with pytest.raises(ValueError, match=str(need)):
        tmesh.make_production_mesh(multi_pod=multi_pod)
    monkeypatch.setattr(tmesh, "world_size", lambda: need)
    m = tmesh.make_production_mesh(multi_pod=multi_pod)
    if multi_pod:
        assert m.shape == {"pod": 2, "data": 16, "model": 16}
    else:
        assert m.shape == {"data": 16, "model": 16}
    assert tmesh.worker_count(m) == (32 if multi_pod else 16)
    assert n_coord_shards(m) == need


def test_mesh_coordinates_are_row_major():
    m = tmesh.Mesh((2, 3, 4), ("pod", "data", "model"))
    for r in range(24):
        c = m.coords(r)
        assert (c["pod"], c["data"], c["model"]) == np.unravel_index(
            r, (2, 3, 4))
        assert m.flat_index(r, ("pod", "data")) == c["pod"] * 3 + c["data"]
        assert m.flat_index(r, m.axis_names) == r
    with pytest.raises(ValueError, match="rank 24 is not in a mesh of 24"):
        m.coords(24)
    with pytest.raises(ValueError, match="does not match axis names"):
        tmesh.Mesh((2, 3), ("pod", "data", "model"))


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((4, 2), ("data", "model")),
                                        ((3, 1), ("data", "model")),
                                        ((16, 16), ("data", "model")),
                                        ((2, 16, 16), ("pod", "data",
                                                       "model"))])
@pytest.mark.parametrize("overrides", [None, {"embed": "model",
                                              "mlp": ("data", "model"),
                                              "vocab": None}])
def test_logical_spec_matches_jax(shape, axes, overrides):
    """Every logical name, in every position, on divisible and
    non-divisible dimensions, and pairs that reuse a mesh axis."""
    from repro.dist.sharding import (current_rules as jax_current_rules,
                                     logical_spec as jax_logical_spec,
                                     use_sharding as jax_use_sharding)
    jm, tm = _jax_mesh(shape, axes), tmesh.Mesh(shape, axes)
    with jax_use_sharding(jm, overrides):
        jrules = dict(jax_current_rules())
    with tsharding.use_sharding(tm, overrides):
        trules = dict(tsharding.current_rules())
        assert tsharding.current_mesh() is tm
    assert tsharding.current_mesh() is None
    assert trules == jrules
    dims = (512, 96, 7, 1, 32)
    for a in NAMES:
        for b in NAMES:
            for da in dims:
                for db in (64, 15):
                    want = tuple(jax_logical_spec((da, db), (a, b), jm,
                                                  jrules))
                    got = tsharding.logical_spec((da, db), (a, b), tm,
                                                 trules)
                    assert got == want, (a, b, da, db)
    three = ("worker", "grad_coord", "embed")
    for d in ((64, 256, 4), (3, 256, 4), (64, 5, 4)):
        assert tsharding.logical_spec(d, three, tm, trules) == tuple(
            jax_logical_spec(d, three, jm, jrules))


def test_use_sharding_widens_on_a_pod_axis():
    pod = tmesh.Mesh((2, 16, 16), ("pod", "data", "model"))
    flat = tmesh.Mesh((16, 16), ("data", "model"))
    with tsharding.use_sharding(pod):
        r = tsharding.current_rules()
        assert r["worker"] == ("pod", "data") == r["batch"]
        assert r["grad_coord"] == ("pod", "data", "model")
        with tsharding.use_sharding(flat, {"worker": None}):
            assert tsharding.current_rules()["worker"] is None
            assert tsharding.current_rules()["grad_coord"] == ("data",
                                                               "model")
        assert tsharding.current_mesh() is pod
    assert tsharding.current_rules() is None


def test_shard_checks_the_rank_and_returns_the_tensor():
    x = torch.zeros(4, 6)
    assert tsharding.shard(x, ("batch",)) is x        # no mesh: unchecked
    with tsharding.use_sharding(tmesh.Mesh((2, 2), ("data", "model"))):
        assert tsharding.shard(x, ("batch", "embed")) is x
        with pytest.raises(ValueError, match="do not match rank-2"):
            tsharding.shard(x, ("batch",))
    with pytest.raises(ValueError, match="do not match rank-2"):
        tsharding.logical_spec((4, 6), ("batch",),
                               tmesh.Mesh((1, 1), ("data", "model")), {})


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_coord_shards_are_jax_views(shards):
    """Shard s's buffer is JAX's ``_to_view`` block s of every leaf,
    concatenated; ``gather`` inverts it; ``take`` from the padded row
    gives the same blocks."""
    import jax.numpy as jnp
    from repro.dist.sharded import _to_view
    rng = np.random.default_rng(shards)
    sizes = (4096, 130, 99, 1)
    X = rng.normal(size=(5, sum(sizes))).astype(np.float32)
    cs = tsharding.CoordShards(sizes, shards)
    offs = np.cumsum((0,) + sizes)
    views = [np.asarray(_to_view(jnp.asarray(X[:, a:b]), shards)[0])
             for a, b in zip(offs[:-1], offs[1:])]
    Xt = torch.from_numpy(X)
    blocks = []
    for s in range(shards):
        want = np.concatenate([v[:, s] for v in views], axis=1)
        got = cs.local(Xt, s)
        np.testing.assert_array_equal(got.numpy(), want)
        blocks.append(got[2])
        row = torch.zeros(cs.padded_numel)
        for i, v in enumerate(cs.padded_views(row, [(n,) for n in sizes])):
            v.copy_(Xt[2, offs[i]:offs[i + 1]])
        out = torch.empty(1, cs.width)
        cs.take(row, slice(s, s + 1), out)
        np.testing.assert_array_equal(out[0].numpy(), want[2])
    flat = cs.gather(torch.stack(blocks), torch.empty(cs.numel))
    np.testing.assert_array_equal(flat.numpy(), X[2])
