"""The MoE block of the port (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the same weights (JAX's ``moe_init``
carried across) and the same numpy inputs, on the reduced mixtral-8x7b
and deepseek-moe-16b configs (fp32 compute, 4 experts, top-2, d_expert
128; deepseek-smoke has one shared expert): drop-free, with drops
(``capacity=8`` for T = 64 tokens), with a shared expert, with a zero
router (every prob tied: experts 0..k-1), the two router losses, and the
gradients of a scalar of the output plus the losses against ``jax.grad``.
The routing -- each token's top-k experts and the set of kept slots -- must
be equal exactly; the JAX side's routing is recomputed with JAX's own
operations as ``moe_apply`` runs them (``repro/models/moe.py:88-115``).
Last, the block's forward and backward hold no float scatter-add: the
aten operations it dispatches, recorded by a ``TorchDispatchMode``.

Tolerances (fp32): outputs to 1e-5 of their largest |y| (each is a sum of
256- and 128-term fp32 products, ~1e2 in size under JAX's bank init (std
1/sqrt(E)), summed in another order); the losses to rtol 1e-6 (fp32
means over 64 tokens); gradients to 1e-4 of each leaf's largest |g|
(products of the same sums, taken back through the softmax).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import moe
from repro_torch.weights import leaf_items, params_from_jax

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

MIXTRAL, DEEPSEEK = "mixtral-8x7b", "deepseek-moe-16b"
B, S = 2, 32                                      # T = 64 tokens
Y_TOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-6, 1e-4


def _cfgs(arch, **moe_kw):
    jcfg, tcfg = jax_reduce(jax_get_config(arch)), reduce_for_smoke(
        get_config(arch))
    if moe_kw:
        jcfg = jcfg.replace(moe=jcfg.moe.__class__(
            **{**jcfg.moe.__dict__, **moe_kw}))
        tcfg = tcfg.replace(moe=tcfg.moe.__class__(
            **{**tcfg.moe.__dict__, **moe_kw}))
    return jcfg, tcfg


def _weights(jcfg, seed, zero_router=False):
    jp = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed),
                                                jcfg))
    if zero_router:
        jp["router"]["w"] = np.zeros_like(jp["router"]["w"])
    return jp


def _x(seed):
    return np.random.default_rng(seed).normal(size=(B, S, 256)).astype(
        np.float32)


def _jax_routing(jp, x, jcfg, capacity=None):
    """top_e and the kept mask (token-major slots) as JAX's moe_apply
    computes them."""
    m = jcfg.moe
    T, k, E = B * S, m.top_k, m.num_experts
    xt = jnp.asarray(x).reshape(T, -1)
    logits = jlayers.linear(jax.tree.map(jnp.asarray, jp["router"]), xt,
                            jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    cap = capacity or int(-(-T * k // E) * m.capacity_factor)
    cap = max(8, min(cap, T))
    flat_e = top_e.reshape(T * k)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    pos = jnp.arange(T * k) - jnp.searchsorted(se, jnp.arange(E))[se]
    keep = jnp.zeros(T * k, bool).at[order].set(pos < cap)
    return np.asarray(top_e), np.asarray(keep), cap


def _port_routing(tp, x, tcfg, capacity=None):
    T = B * S
    _, _, _, top_e = moe.route(tp, torch.from_numpy(x).reshape(T, -1), tcfg)
    cap = moe.capacity_of(T, tcfg, capacity)
    dest, _ = moe.dispatch_plan(top_e, tcfg.moe.num_experts, cap)
    return top_e.numpy(), (dest < tcfg.moe.num_experts * cap).numpy(), cap


CASES = {
    "drop_free": (MIXTRAL, {}, None, False),
    "drops_cap8": (MIXTRAL, {}, 8, False),
    "shared_expert": (DEEPSEEK, {}, None, False),
    "shared_drops_cap8": (DEEPSEEK, {}, 8, False),
    "zero_router_ties": (MIXTRAL, {"capacity_factor": 1.25}, None, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case):
    arch, moe_kw, capacity, zero = CASES[case]
    jcfg, tcfg = _cfgs(arch, **moe_kw)
    jp = _weights(jcfg, 3, zero)
    x = _x(4)
    want_y, want_l = jmoe.moe_apply(jax.tree.map(jnp.asarray, jp),
                                    jnp.asarray(x), jcfg, capacity=capacity)
    tp = params_from_jax(jp)
    with torch.no_grad():
        y, losses = moe.moe_apply(tp, torch.from_numpy(x), tcfg,
                                  capacity=capacity)
    je, jkeep, jcap = _jax_routing(jp, x, jcfg, capacity)
    te, tkeep, tcap = _port_routing(tp, x, tcfg, capacity)
    assert jcap == tcap
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tkeep, jkeep)
    dropped = int((~tkeep).sum())
    if case == "drop_free" or case == "shared_expert":
        assert dropped == 0
    else:
        assert dropped > 0, "the case must drop slots"
    if zero:
        assert (te == np.arange(tcfg.moe.top_k)).all()
    want_y = np.asarray(want_y)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0,
                               atol=Y_TOL * np.abs(want_y).max())
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(losses[k]), float(want_l[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("case", ["drop_free", "drops_cap8",
                                  "shared_drops_cap8"])
def test_moe_gradients_match_jax(case):
    """d/d(params, x) of sum(y * r) + moe_aux + moe_z, r a fixed draw."""
    arch, moe_kw, capacity, zero = CASES[case]
    jcfg, tcfg = _cfgs(arch, **moe_kw)
    jp = _weights(jcfg, 5, zero)
    x = _x(6)
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def jf(p, xx):
        y, ls = jmoe.moe_apply(p, xx, jcfg, capacity=capacity)
        return jnp.sum(y * r) + ls["moe_aux"] + ls["moe_z"]
    gp, gx = jax.grad(jf, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp),
                                          jnp.asarray(x))
    tp = params_from_jax(jp)
    leaves = [t.requires_grad_(True) for _, t in leaf_items(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    y, ls = moe.moe_apply(tp, tx, tcfg, capacity=capacity)
    (torch.sum(y * torch.from_numpy(r)) + ls["moe_aux"]
     + ls["moe_z"]).backward()
    want = [np.asarray(g) for g in jax.tree.leaves(gp)]
    assert len(leaves) == len(want)
    for (path, t), g in zip(leaf_items(tp), want):
        assert np.abs(g).max() > 0, path
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=str(path))
    gx = np.asarray(gx)
    np.testing.assert_allclose(tx.grad.numpy(), gx, rtol=0,
                               atol=GRAD_TOL * np.abs(gx).max())


def test_router_gradient_under_ties_matches_jax():
    """A zero router ties every token to experts 0 and 1 with p = 1/2 and
    drops 24 of each expert's 64 slots (capacity 40): the router's
    gradient (the aux loss's term, the z-loss's and the renormalised kept
    probs') equals JAX's."""
    jcfg, tcfg = _cfgs(MIXTRAL, capacity_factor=1.25)
    jp = _weights(jcfg, 8, zero_router=True)
    x = _x(9)

    def jf(p):
        y, ls = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
        return jnp.sum(y) + ls["moe_aux"] + ls["moe_z"]
    want = np.asarray(jax.grad(jf)(jax.tree.map(jnp.asarray,
                                                jp))["router"]["w"])
    tp = params_from_jax(jp)
    w = tp["router"]["w"].requires_grad_(True)
    y, ls = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    (y.sum() + ls["moe_aux"] + ls["moe_z"]).backward()
    np.testing.assert_allclose(w.grad.numpy(), want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max())


@pytest.mark.parametrize("T,k,E,cap", [(64, 2, 4, 8), (64, 2, 4, 64),
                                       (37, 6, 64, 8), (5, 2, 8, 8)])
def test_dispatch_plan_is_a_partial_permutation(T, k, E, cap):
    """``dest`` and ``cell_src`` are inverse partial maps: a kept slot's
    cell names it back, every other cell is empty, and the kept slots of an
    expert are its first ``cap`` slots in token-major order."""
    g = torch.Generator().manual_seed(T * k + E)
    top_e = torch.stack([torch.randperm(E, generator=g)[:k]
                         for _ in range(T)])
    dest, cell_src = moe.dispatch_plan(top_e, E, cap)
    n = T * k
    kept = dest < E * cap
    slots = torch.arange(n)
    assert torch.equal(cell_src[dest[kept]], slots[kept])
    filled = cell_src < n
    assert torch.equal(dest[cell_src[filled]],
                       torch.arange(E * cap)[filled])
    assert int(filled.sum()) == int(kept.sum())
    flat_e = top_e.reshape(n)
    for e in range(E):
        mine = slots[flat_e == e]
        assert torch.equal(kept[mine], torch.arange(len(mine)) < cap)


@pytest.mark.parametrize("T,E,k,cf,capacity,want", [
    (64, 4, 2, 4.0, None, 64), (64, 4, 2, 1.25, None, 40),
    (64, 4, 2, 1.25, 8, 8), (4, 8, 2, 1.25, None, 8),
    (16384, 8, 2, 1.25, None, 5120), (8192, 64, 6, 1.25, None, 960),
    (16384, 8, 2, 4.0, None, 16384), (7, 3, 2, 1.1, None, 8)])
def test_capacity_matches_jax_integer_arithmetic(T, E, k, cf, capacity,
                                                 want):
    jcfg, tcfg = _cfgs(MIXTRAL)
    m = tcfg.moe.__class__(num_experts=E, top_k=k, capacity_factor=cf)
    got = moe.capacity_of(T, tcfg.replace(moe=m), capacity)
    cap = capacity or int(-(-T * k // E) * cf)
    assert got == max(8, min(cap, T)) == want


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), args, kwargs))
        return func(*args, **kwargs)


def _accumulates(name, args, kwargs) -> bool:
    if name.startswith(("aten.index_add", "aten.scatter_add",
                        "aten.scatter_reduce", "aten.index_reduce",
                        "aten.put", "aten.embedding_dense_backward")):
        return True
    if "index_put" in name:
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        return bool(acc) and args[0].is_floating_point()
    return False


@pytest.mark.parametrize("arch", [MIXTRAL, DEEPSEEK])
def test_moe_forward_and_backward_accumulate_nothing(arch):
    """No float scatter-add, ``index_add_``, accumulating ``index_put_``
    or other order-dependent accumulation in the block's forward and
    backward (with drops), and no host synchronisation
    (``_local_scalar_dense``); the same operations run on the card."""
    jcfg, tcfg = _cfgs(arch)
    tp = params_from_jax(_weights(jcfg, 11))
    for _, t in leaf_items(tp):
        t.requires_grad_(True)
    x = torch.from_numpy(_x(12)).requires_grad_(True)
    with _Ops() as rec:
        y, ls = moe.moe_apply(tp, x, tcfg, capacity=8)
        (y.sum() + ls["moe_aux"] + ls["moe_z"]).backward()
    names = [n for n, _, _ in rec.ops]
    assert "aten.bmm.default" in names and "aten.sort.stable" in names
    bad = [n for n, a, kw in rec.ops if _accumulates(n, a, kw)]
    assert not bad, bad
    assert not [n for n in names if "_local_scalar_dense" in n]
