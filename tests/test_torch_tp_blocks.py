"""Port parity: the tensor-parallel MoE and recurrent blocks (the ``tp``
paths of ``repro_torch.models.moe``, ``ssm`` and ``rglru``) on a gloo
world of 2 CPU ranks with the explicit mesh (data 1, model 2), against
the JAX package's unsharded blocks on the same parameters.

The world is started once for the module (``repro_torch.launch.ranks.
spawn``); its ranks import only ``repro_torch``.  JAX's parameters (its
inits, seeded) and the inputs (numpy, explicit seeds) are carried
across; each rank takes its blocks with ``weights.tp_slice`` of the
layout ``dist.sharding.param_layout`` gives the block's shape tree under
the case's rules, and the ranks' gradient blocks go back together with
``tp_unslice``.  Each block's output and the gradients of every
parameter and of its input (of ``sum(y * cy)``, plus the router losses
for the MoE block) are held at rtol 1e-5 / atol 1e-6 times the
reference's largest magnitude (fp32; a row-parallel product adds two
partial sums where the unsharded one sums in another order:
``tests/test_torch_tensor_parallel.py``'s tolerance and reason), the
atol raised to twice the unsharded port's own largest distance from JAX
on that array where that is larger: the sLSTM's recurrence amplifies
fp32 rounding, and the unsharded port's input gradient is already 2.9e-5
from JAX's (largest 10.5; ``r``'s gradient 1.1e-4 at the FFN factor
1.5):

* the MoE block on mixtral-8x7b's and deepseek-moe-16b's smoke shapes
  (4 experts, top-2; deepseek's shared expert), under the default rules
  (``expert_mlp`` split: a block of ``d_e`` of every expert) and the
  expert-parallel overrides (``experts`` split, as
  ``repro/launch/dryrun.py``'s ``rules_for`` chooses them where the
  experts divide over ``model``: 2 whole experts a rank), drop-free and
  at capacity factor 1.25 (8-28 of the 128 slots dropped: every token
  shares one random direction, which skews the router's load); its
  router losses at rtol 1e-6;
* the RG-LRU block (recurrentgemma-9b's smoke shapes: ``d_rnn`` 256 split),
  the mLSTM block and the sLSTM block (xlstm-1.3b's: 4 heads, 2 a rank;
  the sLSTM's FFN, int(4 / 3 x 256) = 341 wide, does not divide over 2
  ranks and stays replicated, as the rules leave it, and at
  ``slstm_proj_factor`` 1.5, 384 wide, splits).

Both ranks return the same bits of the output, the input's gradient and
every replicated leaf's gradient (the router, the convs, the norms,
deepseek's shared banks under expert parallelism)."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.dist import tensor_parallel
from repro_torch.dist.sharding import param_layout, resolve_rules
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn
from repro_torch.models import moe, rglru, ssm
from repro_torch.weights import leaf_items, map_tree, tp_slice, tp_unslice

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

MESH = Mesh((1, 2), ("data", "model"))
RTOL, ATOL, LOSS_RTOL = 1e-5, 1e-6, 1e-6
EP = {"experts": "model", "expert_mlp": None}
B, S_MOE, S_REC = 2, 32, 16
# (arch, block, rules, variant of the smoke config): "drops" sets the
# MoE capacity factor to 1.25 (the smoke config's 4.0 drops nothing),
# "ff_split" the sLSTM's FFN factor to 1.5
VARIANTS = {None: {}, "drops": {"capacity_factor": 1.25},
            "ff_split": {"slstm_proj_factor": 1.5}}
CASES = tuple((arch, "moe", rules, v)
              for arch in ("mixtral-8x7b", "deepseek-moe-16b")
              for rules in ("default", "experts") for v in (None, "drops")
              ) + (("recurrentgemma-9b", "rglru", "default", None),
                   ("xlstm-1.3b", "mlstm", "default", None),
                   ("xlstm-1.3b", "slstm", "default", None),
                   ("xlstm-1.3b", "slstm", "default", "ff_split"))
IDS = ["-".join(str(x) for x in c) for c in CASES]


def _variant(cfg, variant):
    kw = VARIANTS[variant]
    if "capacity_factor" in kw:
        return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))
    return cfg.replace(**kw)


def _cfg(case):
    return _variant(reduce_for_smoke(get_config(case[0])), case[3])


def _jcfg(case):
    from repro.configs import get_config as jget, reduce_for_smoke as jred
    return _variant(jred(jget(case[0])), case[3])


def _shapes(case):
    cfg, kind = _cfg(case), case[1]
    return {"moe": moe.moe_shapes, "rglru": rglru.rglru_block_shapes,
            "mlstm": ssm.mlstm_block_shapes,
            "slstm": ssm.slstm_block_shapes}[kind](cfg)


def _layout(case, rank=0):
    rules = resolve_rules(MESH, EP if case[2] == "experts" else None)
    return param_layout(_shapes(case), MESH, rules, rank)


def _apply(case, p, x, tp):
    """The port's block -> ``(y, aux)``: ``aux`` the router losses (MoE)
    or ``{}``."""
    cfg, kind = _cfg(case), case[1]
    if kind == "moe":
        return moe.moe_apply(p, x, cfg, tp=tp)
    fn = {"rglru": rglru.rglru_block_apply, "mlstm": ssm.mlstm_block_apply,
          "slstm": ssm.slstm_block_apply}[kind]
    return fn(p, x, cfg, tp=tp)[0], {}


def _rank(rank, data):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        tp = tensor_parallel.for_mesh(MESH, rank)
        out = {}
        for case, (np_p, x_np, cy_np) in data.items():
            p = map_tree(lambda a: torch.from_numpy(np.array(a))
                         .requires_grad_(True),
                         tp_slice(np_p, _layout(case, rank)))
            x = torch.from_numpy(x_np).requires_grad_(True)
            y, aux = _apply(case, p, x, tp)
            obj = (y * torch.from_numpy(cy_np)).sum()
            (obj + sum(aux.values())).backward()
            out[case] = {"y": y.detach().numpy(),
                         "aux": {k: float(v) for k, v in aux.items()},
                         "grads": [t.grad.numpy().copy()
                                   for _, t in leaf_items(p)],
                         "gx": x.grad.numpy()}
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def data():
    """JAX's block parameters (its inits) with an input and an output
    cotangent per case."""
    import jax
    from repro.models import moe as jmoe, rglru as jrglru, ssm as jssm
    init = {"moe": jmoe.moe_init, "rglru": jrglru.rglru_block_init,
            "mlstm": jssm.mlstm_block_init, "slstm": jssm.slstm_block_init}
    out = {}
    for i, case in enumerate(CASES):
        jcfg = _jcfg(case)
        p = init[case[1]](jax.random.PRNGKey(40 + i), jcfg)
        S = S_MOE if case[1] == "moe" else S_REC
        rng = np.random.default_rng(200 + i)
        x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
        if case[1] == "moe":        # a direction every token shares: a
            x += rng.normal(size=jcfg.d_model).astype(np.float32)  # skew
        cy = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
        out[case] = (jax.tree.map(np.asarray, p), x, cy)
    return out


@pytest.fixture(scope="module")
def world(data):
    return spawn(_rank, 2, data, timeout=300)


def _jax_ref(case, np_p, x, cy):
    """JAX's unsharded block: output, router losses and the gradients of
    the parameters (leaf order) and of the input."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe, rglru as jrglru, ssm as jssm
    jcfg, kind = _jcfg(case), case[1]

    def fn(p, x):
        if kind == "moe":
            return jmoe.moe_apply(p, x, jcfg)
        f = {"rglru": jrglru.rglru_block_apply,
             "mlstm": jssm.mlstm_block_apply,
             "slstm": jssm.slstm_block_apply}[kind]
        return f(p, x, jcfg)[0], {}

    def obj(p, x):
        y, aux = fn(p, x)
        return jnp.sum(y * jnp.asarray(cy)) + sum(aux.values())
    p, xj = jax.tree.map(jnp.asarray, np_p), jnp.asarray(x)
    y, aux = fn(p, xj)
    gp, gx = jax.grad(obj, argnums=(0, 1))(p, xj)
    return (np.asarray(y), {k: float(v) for k, v in aux.items()},
            [np.asarray(g) for _, g in leaf_items(
                jax.tree.map(np.asarray, gp))], np.asarray(gx))


def _port_ref(case, np_p, x, cy):
    """The port's unsharded block, as :func:`_jax_ref`."""
    p = map_tree(lambda a: torch.from_numpy(np.array(a)).requires_grad_(
        True), np_p)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = _apply(case, p, xt, None)
    ((y * torch.from_numpy(cy)).sum() + sum(aux.values())).backward()
    return (y.detach().numpy(), {k: float(v) for k, v in aux.items()},
            [t.grad.numpy() for _, t in leaf_items(p)], xt.grad.numpy())


def _close(a, b, base, what):
    """``a`` against JAX's ``b``: rtol 1e-5, atol the larger of 1e-6 of
    ``b``'s largest magnitude (at least 1e-6) and twice the unsharded
    port's ``base`` largest distance from ``b`` (module docstring)."""
    atol = max(ATOL * max(1.0, float(np.abs(b).max())),
               2 * float(np.abs(base - b).max()))
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tp_block_matches_jax_unsharded(case, world, data):
    np_p, x, cy = data[case]
    y, aux, gp, gx = _jax_ref(case, np_p, x, cy)
    by, _, bgp, bgx = _port_ref(case, np_p, x, cy)
    lay = _layout(case)
    assert lay.is_split
    for r, res in enumerate(world):
        _close(res[case]["y"], y, by, f"rank {r} output")
        _close(res[case]["gx"], gx, bgx, f"rank {r} input grad")
        assert res[case]["aux"].keys() == aux.keys()
        for k, v in aux.items():
            np.testing.assert_allclose(res[case]["aux"][k], v,
                                       rtol=LOSS_RTOL, err_msg=k)
    trees = [map_tree(lambda i, r=r: world[r][case]["grads"][i],
                      lay.full.skeleton) for r in range(2)]
    whole = tp_unslice(trees, lay)
    for (path, g), want, base in zip(leaf_items(whole), gp, bgp,
                                     strict=True):
        _close(g, want, base, f"grad {path}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tp_block_replicated_values_are_the_same_bits(case, world):
    a, b = (r[case] for r in world)
    np.testing.assert_array_equal(a["y"], b["y"])
    np.testing.assert_array_equal(a["gx"], b["gx"])
    assert a["aux"] == b["aux"]
    lay = _layout(case)
    replicated = [path for path, d in zip(lay.full.paths, lay.dims)
                  if d is None]
    for (path, ga, gb), d in zip(zip(lay.full.paths, a["grads"],
                                     b["grads"]), lay.dims):
        if d is None:
            np.testing.assert_array_equal(ga, gb, err_msg=str(path))
    kind, rules = case[1], case[2]
    want = {"moe": [("router", "w")] + (
        [("shared", n) for n in ("w_down", "w_gate", "w_up")]
        if rules == "experts" and "deepseek" in case[0] else []),
        "rglru": [("conv", "b"), ("conv", "w")],
        "mlstm": [("conv", "b"), ("conv", "w"), ("norm", "scale")],
        "slstm": [("norm", "scale")]}[kind]
    if kind == "slstm" and case[3] is None:     # 341 wide: replicated
        want = [(n, "w") for n in ("ff_down", "ff_gate", "ff_up")] + want
    assert replicated == want


def test_moe_drops_slots_at_capacity_factor_1_25(data):
    """The dropping cases drop slots, the others none (the unsharded
    plan on the case's own router and input)."""
    for case in CASES:
        if case[1] != "moe":
            continue
        cfg = _cfg(case)
        np_p, x, _ = data[case]
        xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
        _, _, _, top_e = moe.route({"router": {"w": torch.from_numpy(
            np_p["router"]["w"])}}, xt, cfg)
        dest, _ = moe.dispatch_plan(top_e, cfg.moe.num_experts,
                                    moe.capacity_of(xt.shape[0], cfg))
        dropped = int((dest == cfg.moe.num_experts * moe.capacity_of(
            xt.shape[0], cfg)).sum())
        assert (dropped > 0) == (case[3] == "drops"), (case, dropped)
