"""Port parity at bf16 compute: the tensor-parallel sums over the ``model``
group run in fp32, cast once after the sum, as JAX's partitioned
programs do (a split ``dot_general(bf16, bf16, preferred_element_type=
f32).astype(bf16)`` all-reduces the f32 product and converts after).

A gloo world of 2 CPU ranks with the mesh (data 1, model 2)
(``repro_torch.launch.ranks.spawn``; its ranks import only
``repro_torch``), inputs from numpy with explicit seeds.  One case a site
the PRECISION rule flags (``repro_torch.analysis.rules.check_precision``
on the ``tp/*`` lint entries):

* ``row_linear`` -- attention's ``wo`` and the MLP's ``down``: a (64,
  960) @ (960, 960) product, weights sigma 0.03, the contraction split 2
  ways, against JAX's ``layers.linear`` at bf16;
* ``copy_grad`` -- ``TensorParallel.copy``'s backward, the gradient of a
  column-parallel product's bf16 input (the output split 2 ways), against
  ``jax.grad`` of JAX's ``layers.linear`` at bf16;
* ``moe_expert`` -- the MoE block with its expert banks and shared
  experts split over ``d_e`` (deepseek-moe-16b's smoke shapes at bf16
  compute, no drops), against JAX's ``moe.moe_apply`` under ``jax.jit``.
  Its down product accumulates in fp32 and casts once, as JAX's
  ``preferred_element_type`` einsum, and its activation rounds after
  every primitive as JAX's does (``repro_torch.models.activations``).

Each is held to at most 1 bf16 ulp of the reference's magnitude, and
equal in at least 99.9 % of the elements.  Summing bf16-rounded partials
(the order before the repair) leaves 37.4 % of ``row_linear``'s outputs
different, by up to 248 ulps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.dist import tensor_parallel
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn
from repro_torch.models import layers, moe

MESH = Mesh((1, 2), ("data", "model"))
BF = torch.bfloat16
T, D = 64, 960
MAX_ULPS, MIN_EQUAL = 1.0, 0.999


def _moe_cfg():
    cfg = reduce_for_smoke(get_config("deepseek-moe-16b"))
    return cfg.replace(compute_dtype="bfloat16", moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    cfg = _moe_cfg()
    m, d = cfg.moe, cfg.d_model
    de = m.d_expert or cfg.d_ff
    E, ns = m.num_experts, m.num_shared

    def bank(n, a, b):
        return (rng.normal(size=(n, a, b)) * 0.05).astype(f32)
    return {
        "x": rng.normal(size=(T, D)).astype(f32),
        "w": (rng.normal(size=(D, D)) * 0.03).astype(f32),
        "cy": rng.normal(size=(T, D)).astype(f32),
        "moe": {"router": {"w": (rng.normal(size=(d, E)) * 0.1).astype(f32)},
                "w_up": bank(E, d, de), "w_gate": bank(E, d, de),
                "w_down": bank(E, de, d),
                "shared": {"w_up": bank(ns, d, de),
                           "w_gate": bank(ns, d, de),
                           "w_down": bank(ns, de, d)}},
        "moe_x": rng.normal(size=(2, 16, d)).astype(f32),
    }


def _moe_block(p: dict, rank: int, parts: int) -> dict:
    """The rank's banks: a block of ``d_e`` of every expert."""
    de = p["w_up"].shape[-1]
    s = slice(rank * de // parts, (rank + 1) * de // parts)

    def cut(b):
        return {"w_up": b["w_up"][..., s], "w_gate": b["w_gate"][..., s],
                "w_down": b["w_down"][:, s]}
    return {"router": p["router"], **cut(p), "shared": cut(p["shared"])}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _rank(rank, data):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        tp = tensor_parallel.for_mesh(MESH, rank)
        h = D // 2
        s = slice(rank * h, (rank + 1) * h)
        x = torch.from_numpy(data["x"]).to(BF)
        out = {"row_linear": layers.row_linear(
            {"w": torch.from_numpy(data["w"][s])}, x[:, s], BF,
            tp).float().numpy()}
        xg = x.clone().requires_grad_(True)
        y = layers.linear({"w": torch.from_numpy(data["w"][:, s])},
                          tp.copy(xg), BF)
        (y.float() * torch.from_numpy(data["cy"][:, s])).sum().backward()
        out["copy_grad"] = xg.grad.float().numpy()
        cfg = _moe_cfg()
        p = _torch(_moe_block(data["moe"], rank, tp.parts))
        with torch.no_grad():
            ym, _ = moe.moe_apply(p, torch.from_numpy(data["moe_x"]).to(BF),
                                  cfg, tp=tp)
        out["moe_expert"] = ym.float().numpy()
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world():
    data = _inputs()
    return data, spawn(_rank, 2, data, timeout=240)


def _references(data) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.models import layers as jlayers
    w = jnp.asarray(data["w"])
    xb = jnp.asarray(data["x"], jnp.bfloat16)
    ref = {"row_linear": np.asarray(jlayers.linear(
        {"w": w}, xb, jnp.bfloat16).astype(jnp.float32))}
    cy = jnp.asarray(data["cy"])
    ref["copy_grad"] = np.asarray(jax.grad(lambda a: (jlayers.linear(
        {"w": w}, a, jnp.bfloat16).astype(jnp.float32) * cy).sum())(
            xb).astype(jnp.float32))
    from repro.configs import get_config as jget
    from repro.configs import reduce_for_smoke as jreduce
    from repro.models import moe as jmoe
    jcfg = jreduce(jget("deepseek-moe-16b"))
    jcfg = jcfg.replace(compute_dtype="bfloat16", moe=dataclasses.replace(
        jcfg.moe, capacity_factor=8.0))
    ym = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg)[0])(
        jax.tree.map(jnp.asarray, data["moe"]),
        jnp.asarray(data["moe_x"], jnp.bfloat16))
    ref["moe_expert"] = np.asarray(ym.astype(jnp.float32))
    return ref


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger magnitude."""
    mag = np.maximum(np.abs(got), np.abs(want))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7
    return np.abs(got - want) / np.exp2(exp)


@pytest.mark.parametrize("site", ["row_linear", "copy_grad", "moe_expert"])
def test_tp_sum_in_fp32_matches_one_cast(world, site):
    data, ranks = world
    want = _references(data)[site]
    for r, out in enumerate(ranks):
        got = out[site]
        assert got.shape == want.shape
        equal = float((got == want).mean())
        worst = float(_ulps(got, want).max())
        assert worst <= MAX_ULPS and equal >= MIN_EQUAL, (
            f"rank {r} {site}: {1 - equal:.4%} of the elements differ, "
            f"up to {worst} bf16 ulps")
    # the group's ranks hold the same bits of the replicated result
    assert np.array_equal(ranks[0][site], ranks[1][site])
