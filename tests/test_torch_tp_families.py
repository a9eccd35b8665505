"""Port parity: one tensor-parallel train step of each model family
beyond the dense transformer -- deepseek-moe-16b (its dense head and two
MoE layers with a shared expert), xlstm-1.3b (one period of an mLSTM and
an sLSTM block), recurrentgemma-9b (rglru, rglru, attn) and
musicgen-medium with its frontend prefix -- on a gloo world of 4 CPU
ranks (the host mesh (data 2, model 2)), against the JAX package's
unsharded step.

The world is started once for the module (``repro_torch.launch.ranks.
spawn``); its ranks import only ``repro_torch``.  JAX's parameters (its
init, seeded) are carried across: ``init_train_state(..., params=,
sharded=mesh)`` cuts each rank's blocks out of them under the default
rules, and the ranks' blocks go back together with ``tp_unslice``.  The
setting is ``tests/test_torch_tp_train.py``'s (the smoke configs, SGD
momentum 0.9, flag lambda 0, tol 0, constant 1e-3, seeded tokens; W = 4,
the split path: each data group computes 2 workers, its two ranks each
their half of the model), and so are the tolerances: the loss rtol 1e-6,
the FA weights and the parameters rtol 1e-4 / atol 1e-5 (the unsharded
port's step is within 1.6e-6 / 6e-8 of JAX's in this setting).  Also:

* every rank's metrics are the same bits, the ranks of a data group the
  same parameter bits, and each rank holds its blocks (``tp.local``);
* in one tensor-parallel forward and backward of each configuration on
  one worker's batch, the two ranks of a ``model`` group return the same
  bits of the loss and of the gradient of every replicated leaf (the
  norms, the convs, the router, the projector): the coordinate shards
  take a replicated leaf's gradient from the receiving rank's own copy.

Without a world: AdamW's update in blocks is the whole-vector update's
bits.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.flag import FlagConfig
from repro_torch.dist import tensor_parallel
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.sharding import resolve_rules, use_sharding
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state)
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn
from repro_torch.models import transformer
from repro_torch.optim import constant, sgd
from repro_torch.weights import (leaf_items, map_tree, pack, tp_slice,
                                 tp_unslice, unflatten)

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

MESH = Mesh((2, 2), ("data", "model"))
FAMILIES = ("deepseek-moe-16b", "xlstm-1.3b", "recurrentgemma-9b",
            "musicgen-medium")
W, BW, SW = 4, 2, 16
LOSS_RTOL, RTOL, ATOL = 1e-6, 1e-4, 1e-5


def _variant(cfg):
    if cfg.name.startswith("recurrentgemma"):
        return cfg.replace(block_pattern=("rglru", "rglru", "attn"),
                           num_layers=3)
    return cfg


def _cfg(arch):
    return _variant(reduce_for_smoke(get_config(arch)))


def _jcfg(arch):
    from repro.configs import get_config as jget, reduce_for_smoke as jred
    return _variant(jred(jget(arch)))


def _batch(arch, seed=23):
    """Worker-major tokens and labels (and musicgen's prefix)."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (W, BW, SW + 1), dtype=np.int32)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.frontend is not None:
        out["prefix_embeds"] = rng.normal(size=(
            W, BW, cfg.num_prefix_embeds, cfg.d_frontend)).astype(np.float32)
    return out


def _tc():
    return TrainConfig(aggregator=AggregatorConfig(
        name="flag", flag=FlagConfig(lam=0.0, regularizer="none", tol=0.0)),
        sharded_agg=True)


def _layouts(arch):
    cfg = _cfg(arch)
    return [transformer.tp_layout(cfg, MESH, resolve_rules(MESH), r)
            for r in range(MESH.size)]


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _step(cfg, np_params, batch, mesh):
    opt = sgd(momentum=0.9)
    state = init_train_state(cfg, opt, params=np_params, sharded=mesh)
    step = build_train_step(cfg, _tc(), opt, constant(1e-3))
    m = step(state, _torch(batch), 0)
    return {"loss": float(m["loss"]), "c": m["fa_weights"].numpy().copy(),
            "d_norm": float(m["grad_global_norm"]),
            "flat": state.flat.numpy().copy(),
            "shapes": state.layout.shapes}


def _replicated_grads(cfg, np_params, batch, rank):
    """One tensor-parallel forward and backward on worker 0's batch: the
    loss and the gradients of the replicated leaves."""
    lay = transformer.tp_layout(cfg, MESH, resolve_rules(MESH), rank)
    p = map_tree(lambda a: torch.from_numpy(np.array(a)).requires_grad_(
        True), tp_slice(np_params, lay))
    tp = tensor_parallel.for_mesh(MESH, rank)
    loss, _ = transformer.forward(p, {k: v[0] for k, v in _torch(
        batch).items()}, cfg, tp)
    loss.backward()
    return float(loss), [t.grad.numpy().copy() if t.grad is not None
                         else None for (_, t), d in zip(leaf_items(p),
                                                        lay.dims)
                         if d is None]


def _rank(rank, np_params):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        out = {}
        with use_sharding(MESH):
            for arch in FAMILIES:
                cfg, batch = _cfg(arch), _batch(arch)
                out[arch] = _step(cfg, np_params[arch], batch, MESH)
                out[arch]["fwd"] = _replicated_grads(cfg, np_params[arch],
                                                     batch, rank)
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def np_params():
    import jax
    from repro.models import transformer as jtransformer
    return {arch: jax.tree.map(np.asarray, jtransformer.init_params(
        jax.random.PRNGKey(0), _jcfg(arch))) for arch in FAMILIES}


@pytest.fixture(scope="module")
def world_and_refs(np_params):
    """The world's results, and JAX's steps computed here while the
    ranks run."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, _rank, MESH.size, np_params, timeout=300)
        refs = {arch: _jax_step(arch, np_params[arch]) for arch in FAMILIES}
        return fut.result(), refs


@pytest.fixture(scope="module")
def world(world_and_refs):
    return world_and_refs[0]


@pytest.fixture(scope="module")
def refs(world_and_refs):
    return world_and_refs[1]


def _jax_step(arch, np_p):
    import jax
    import jax.numpy as jnp
    from repro.core.flag import FlagConfig as JFlag
    from repro.dist.aggregation import AggregatorConfig as JAgg
    from repro.dist.train_step import (TrainConfig as JTrainConfig,
                                       build_train_step as jbuild)
    from repro.optim import constant as jconstant, sgd as jsgd
    opt = jsgd(momentum=0.9)
    params = jax.tree.map(jnp.asarray, np_p)
    tc = JTrainConfig(aggregator=JAgg(name="flag", flag=JFlag(
        lam=0.0, regularizer="none", tol=0.0)))
    step = jax.jit(jbuild(_jcfg(arch), tc, opt, jconstant(1e-3)))
    p, _, m = step(params, opt.init(params),
                   jax.tree.map(jnp.asarray, _batch(arch)),
                   jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
    return {"loss": float(m["loss"]), "c": np.asarray(m["fa_weights"]),
            "flat": np.concatenate([np.asarray(x).reshape(-1)
                                    for x in jax.tree.leaves(p)])}


def _whole(res, key, layouts):
    """The whole flat vector of ``key`` from the blocks of ranks 0 and 1
    (data group 0's ``model`` group)."""
    trees = [unflatten(torch.from_numpy(res[r][key]), layouts[r].local)
             for r in range(2)]
    return pack(tp_unslice(trees, layouts[0]))[0].numpy()


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp_step_of_each_family_matches_jax_unsharded(arch, world, refs):
    lays = _layouts(arch)
    assert lays[0].is_split
    got = [r[arch] for r in world]
    want = refs[arch]
    for r in got[1:]:
        assert r["loss"] == got[0]["loss"]
        assert r["d_norm"] == got[0]["d_norm"]
        np.testing.assert_array_equal(r["c"], got[0]["c"])
    for r in (0, 1):                      # data groups hold the same bits
        np.testing.assert_array_equal(got[r]["flat"], got[r + 2]["flat"])
    assert np.isfinite(got[0]["loss"])
    np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[0]["c"], want["c"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_whole(got, "flat", lays), want["flat"],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_each_rank_holds_its_blocks_and_replicated_grads_agree(arch, world):
    lays = _layouts(arch)
    full = lays[0].full
    for r, res in enumerate(world):
        lay = lays[r]
        assert tuple(res[arch]["shapes"]) == lay.local.shapes
        assert res[arch]["flat"].size == lay.local.numel < full.numel
        for shape, local, d in zip(full.shapes, lay.local.shapes, lay.dims):
            assert local == shape if d is None else local[d] * 2 == shape[d]
    for a, b in ((0, 1), (2, 3)):
        la, ga = world[a][arch]["fwd"]
        lb, gb = world[b][arch]["fwd"]
        assert la == lb
        assert len(ga) == len(gb) > 0
        for x, y in zip(ga, gb):
            if x is None:           # e.g. the token path's unused leaves
                assert y is None
            else:
                np.testing.assert_array_equal(x, y)


def test_adamw_in_blocks_is_the_whole_vector_update(monkeypatch):
    """AdamW's update ``UPDATE_BLOCK`` entries at a time equals, bit for
    bit, the same arithmetic on the whole vectors (written out here), over
    three steps."""
    from repro_torch.optim import adamw, optimizers
    monkeypatch.setattr(optimizers, "UPDATE_BLOCK", 7)
    b1, b2, eps, wd, lr = 0.9, 0.95, 1e-8, 0.1, 1e-2
    rng = np.random.default_rng(9)
    p0 = torch.from_numpy(rng.normal(size=100).astype(np.float32))
    opt = adamw()
    state, p = opt.init(p0), p0.clone()
    mu, nu, q = torch.zeros(100), torch.zeros(100), p0.clone()
    for t in range(1, 4):
        g = torch.from_numpy(rng.normal(size=100).astype(np.float32))
        upd, state = opt.update(g, state, p, lr)
        p = p + upd
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * torch.square(g))
        tt = torch.tensor(t, dtype=torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1), tt)
        c2 = 1 - torch.pow(torch.tensor(b2), tt)
        want = (mu / c1).div_(torch.sqrt(nu / c2).add_(eps)).add_(
            wd * q).mul_(-lr)
        q = q + want
        np.testing.assert_array_equal(upd.numpy(), want.numpy())
        np.testing.assert_array_equal(state["mu"].numpy(), mu.numpy())
        np.testing.assert_array_equal(state["nu"].numpy(), nu.numpy())


@pytest.mark.parametrize("arch,rules", [
    ("deepseek-moe-16b", None), ("mixtral-8x7b", "experts"),
    ("xlstm-1.3b", None), ("recurrentgemma-9b", None),
    ("musicgen-medium", None), ("smollm-360m", None)])
def test_a_rank_draws_its_blocks_of_the_whole_draw(arch, rules, monkeypatch):
    """``init_params(..., layout=)`` draws only the blocks that hold some
    of the rank's block, and its tree is the rank's block of the whole
    tree's draw, bit for bit (draw blocks of 1,000 weights: most leaves
    span many, and a rank skips some)."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "DRAW_BLOCK", 1000)
    cfg = _cfg(arch)
    rules = resolve_rules(MESH, {"experts": "model", "expert_mlp": None}
                          if rules else None)
    whole = transformer.init_params(cfg, seed=3)
    for r in range(MESH.size):
        lay = transformer.tp_layout(cfg, MESH, rules, r)
        got = transformer.init_params(cfg, seed=3, layout=lay)
        for (path, a), (_, b) in zip(leaf_items(got),
                                     leaf_items(tp_slice(whole, lay))):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=str(path))
    skipped = [~transformer._blocks_needed(lay, i)
               for i, d in enumerate(lay.dims) if d is not None]
    assert any(s.any() for s in skipped)
