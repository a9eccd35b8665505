"""Port parity: the tensor-parallel layers (``repro_torch.dist.
tensor_parallel`` and the ``tp`` paths of ``repro_torch.models``) on a
gloo world of 2 CPU ranks with the explicit mesh (data 1, model 2),
against the JAX package's unsharded functions on the same parameters.

The world is started once for the module (``repro_torch.launch.ranks.
spawn``); its ranks import only ``repro_torch`` and hand back their
outputs and the gradients of their parameter blocks and inputs.  The
JAX package's parameters (its inits, seeded) and the inputs (numpy,
explicit seeds) are carried across; each rank takes its blocks with
``weights.tp_slice`` of the layout ``dist.sharding.param_layout`` gives,
and the ranks' gradient blocks go back together with ``tp_unslice``.
Held at rtol 1e-5 / atol 1e-6 times the reference's largest magnitude
(fp32; a row-parallel product or a vocab-parallel sum adds two partial
sums, the unsharded one sums in another order; the unsharded port's
attention gradients are already 2.4e-7 of their largest entry from
JAX's):

* column- and row-parallel ``linear`` with biases (the column bias split,
  the row bias added once after the sum);
* the vocab-parallel embedding, unembedding and NLL;
* attention with the heads split over the ranks (4 heads, 2 KV heads,
  with biases) and with ``qkv`` split mid-head (3 heads, 1 KV head,
  head_dim 64, as smollm-360m's 15 / 5 on 2 ranks: q / k / v gathered);
* the gated MLP (SwiGLU) and the plain one with biases (GELU).

Outputs and the gradients of every parameter and of the input are held;
both ranks return the same bits of every replicated value.  Without a
world: ``tp_slice`` then ``tp_unslice`` is the identity, and the layout
of every leaf of every configuration (full and smoke; the MoE ones also
under the expert-parallel overrides) is the one the JAX package's
``logical_spec`` gives for the axes its own init annotates (its
``shard`` calls, recorded)."""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.dist import tensor_parallel
from repro_torch.dist.sharding import param_layout, resolve_rules
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn
from repro_torch.models import attention, layers, mlp, transformer
from repro_torch.weights import (leaf_items, map_tree, tp_slice,
                                 tp_unslice)

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

MESH = Mesh((1, 2), ("data", "model"))
RTOL, ATOL = 1e-5, 1e-6
ARCHS = ("xlstm-1.3b", "smollm-360m", "mixtral-8x7b", "starcoder2-15b",
         "stablelm-1.6b", "command-r-35b", "deepseek-moe-16b",
         "musicgen-medium", "recurrentgemma-9b", "phi-3-vision-4.2b")
MOE = ("mixtral-8x7b", "deepseek-moe-16b")
# the expert-parallel overrides (repro/launch/dryrun.py's rules_for, where
# the experts divide over model)
EP = {"experts": "model", "expert_mlp": None}
B, S = 2, 8


def _attn_cfg(name):
    """heads split (4 / 2, biases) or qkv split mid-head (3 / 1)."""
    if name == "heads_split":
        return reduce_for_smoke(get_config("starcoder2-15b"))
    return reduce_for_smoke(get_config("smollm-360m")).replace(
        num_heads=3, num_kv_heads=1, head_dim=64)


def _mlp_cfg(name):
    return reduce_for_smoke(get_config(
        "smollm-360m" if name == "gated" else "starcoder2-15b"))


def _lin_shapes(kind):
    axes = ("embed", "mlp") if kind == "col" else ("mlp", "embed")
    d_in, d_out = (16, 12) if kind == "col" else (12, 16)
    return layers.linear_shapes(d_in, d_out, use_bias=True, axes=axes)


def _table_shapes():
    return {"table": layers.meta(64, 16, axes=("vocab", "embed"))}


def _layout(shapes, rank=0):
    return param_layout(shapes, MESH, resolve_rules(MESH), rank)


def _wblock(kind, lay, rank):
    """The slice of ``w``'s split dimension (leaf 1: ``b`` sorts first)
    that ``rank`` holds: its columns (``col``) or rows (``row``)."""
    return lay.block(1, rank)[1 if kind == "col" else 0]


def _inputs():
    """Every case's numpy inputs, explicit seeds."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    out = {
        "col": {"p": {"w": rng.normal(size=(16, 12)).astype(f32),
                      "b": rng.normal(size=(12,)).astype(f32)},
                "x": rng.normal(size=(B, S, 16)).astype(f32),
                "cy": rng.normal(size=(B, S, 12)).astype(f32)},
        "row": {"p": {"w": rng.normal(size=(12, 16)).astype(f32),
                      "b": rng.normal(size=(16,)).astype(f32)},
                "x": rng.normal(size=(B, S, 12)).astype(f32),
                "cy": rng.normal(size=(B, S, 16)).astype(f32)},
        "vocab": {"p": {"table": rng.normal(size=(64, 16)).astype(f32)},
                  "ids": rng.integers(0, 64, (B, S)).astype(np.int32),
                  "labels": rng.integers(0, 64, (B, S)).astype(np.int32),
                  "x": rng.normal(size=(B, S, 16)).astype(f32),
                  "cy": rng.normal(size=(B, S, 16)).astype(f32),
                  "cl": rng.normal(size=(B, S, 64)).astype(f32),
                  "cn": rng.normal(size=(B, S)).astype(f32)},
    }
    return out


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _local(np_tree, tp):
    return map_tree(lambda a: _t(a, True), tp_slice(np_tree, tp))


def _grads(tree):
    return [t.grad.numpy().copy() for _, t in leaf_items(tree)]


def _rank(rank, data, block_params):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        tp = tensor_parallel.for_mesh(MESH, rank)
        f32 = torch.float32
        out = {}
        for kind in ("col", "row"):
            case = data[kind]
            lay = _layout(_lin_shapes(kind), rank)
            p = _local(case["p"], lay)
            if kind == "col":
                x = _t(case["x"], True)
                y = layers.linear(p, tp.copy(x), f32)
                cy = _t(case["cy"])[..., _wblock(kind, lay, rank)]
            else:
                x = _t(case["x"][..., _wblock(kind, lay, rank)], True)
                y = layers.row_linear(p, x, f32, tp)
                cy = _t(case["cy"])
            (y * cy).sum().backward()
            out[kind] = (y.detach().numpy(), _grads(p), x.grad.numpy())
        case = data["vocab"]
        lay = _layout(_table_shapes(), rank)
        p = _local(case["p"], lay)
        y = layers.embed(p, _t(case["ids"]), f32, tp)
        (y * _t(case["cy"])).sum().backward()
        out["embed"] = (y.detach().numpy(), _grads(p), None)
        p = _local(case["p"], lay)
        x = _t(case["x"], True)
        logits = layers.unembed(p, x, f32, tp)
        (logits * _t(case["cl"])[..., lay.block(0)[0]]).sum().backward()
        out["unembed"] = (logits.detach().numpy(), _grads(p),
                          x.grad.numpy())
        p = _local(case["p"], lay)
        x = _t(case["x"], True)
        nll = tp.vocab_nll(layers.unembed(p, x, f32, tp),
                           _t(case["labels"]).long())
        (nll * _t(case["cn"])).sum().backward()
        out["nll"] = (nll.detach().numpy(), _grads(p), x.grad.numpy())
        for name, (np_p, x_np, cy_np) in block_params.items():
            kind, variant = name
            cfg = (_attn_cfg if kind == "attn" else _mlp_cfg)(variant)
            shapes = transformer._block_shapes(cfg, "attn", 0)[
                "mixer" if kind == "attn" else "ffn"]
            p = _local(np_p, _layout(shapes, rank))
            x = _t(x_np, True)
            if kind == "attn":
                pos = torch.arange(S)[None].expand(B, S)
                y = attention.attn_apply(p, x, cfg, positions=pos, tp=tp)
            else:
                y = mlp.mlp_apply(p, x, cfg, tp)
            (y * _t(cy_np)).sum().backward()
            out[name] = (y.detach().numpy(), _grads(p), x.grad.numpy())
        return out
    finally:
        dist.destroy_process_group()


BLOCKS = [("attn", "heads_split"), ("attn", "mid_head"), ("mlp", "gated"),
          ("mlp", "plain")]


def _jax_cfg(kind, variant):
    from repro.configs import get_config as jget, reduce_for_smoke as jred
    if kind == "attn":
        if variant == "heads_split":
            return jred(jget("starcoder2-15b"))
        return jred(jget("smollm-360m")).replace(num_heads=3,
                                                 num_kv_heads=1, head_dim=64)
    return jred(jget("smollm-360m" if variant == "gated"
                     else "starcoder2-15b"))


@pytest.fixture(scope="module")
def block_params():
    """JAX's attention and MLP params (its inits) with an input and an
    output cotangent per block case."""
    import jax
    from repro.models import attention as jattn, mlp as jmlp
    out = {}
    for i, (kind, variant) in enumerate(BLOCKS):
        jcfg = _jax_cfg(kind, variant)
        key = jax.random.PRNGKey(7 + i)
        p = (jattn.attn_init(key, jcfg) if kind == "attn"
             else jmlp.mlp_init(key, jcfg))
        rng = np.random.default_rng(100 + i)
        x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
        cy = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
        out[kind, variant] = (jax.tree.map(np.asarray, p), x, cy)
    return out


@pytest.fixture(scope="module")
def world(block_params):
    return spawn(_rank, 2, _inputs(), block_params, timeout=300)


def _jax_vjp(fn, *args):
    """``fn(*args)`` and the gradients of ``sum(fn(*args) * ct)`` in every
    argument but the last (``ct``)."""
    import jax
    import jax.numpy as jnp
    args = [jax.tree.map(jnp.asarray, a) for a in args]
    y = fn(*args[:-1])
    g = jax.grad(lambda *a: jnp.sum(fn(*a) * args[-1]),
                 argnums=tuple(range(len(args) - 1)))(*args[:-1])
    return np.asarray(y), jax.tree.map(np.asarray, g)


def _whole(res, key, shapes):
    lay = _layout(shapes)
    trees = [map_tree(lambda i, r=r: r[key][1][i], lay.full.skeleton)
             for r in res]
    return [g for _, g in leaf_items(tp_unslice(trees, lay))]


def _close(a, b, what):
    """rtol 1e-5, atol 1e-6 of the reference's largest magnitude (at
    least 1e-6): the unsharded port's attention gradients are already up
    to 2.4e-7 of their largest entry from JAX's (5.7e-6 at 23.7), which
    an absolute 1e-6 would fail on the small entries of a large array."""
    np.testing.assert_allclose(
        a, b, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(b).max())),
        err_msg=what)


@pytest.mark.parametrize("kind", ["col", "row"])
def test_parallel_linear_matches_jax(kind, world):
    from repro.models import layers as jlayers
    case = _inputs()[kind]
    y, (gp, gx) = _jax_vjp(
        lambda p, x: jlayers.linear(p, x, np.float32), case["p"], case["x"],
        case["cy"])
    lay = _layout(_lin_shapes(kind))
    for r, res in enumerate(world):
        got_y, _, got_gx = res[kind]
        if kind == "col":
            _close(got_y, y[..., _wblock(kind, lay, r)], "y block")
            _close(got_gx, gx, "input grad")
        else:
            _close(got_y, y, "y")
            _close(got_gx, gx[..., _wblock(kind, lay, r)],
                   "input grad block")
    for g, want, (path, _) in zip(_whole(world, kind, _lin_shapes(kind)),
                                  [gp[k] for k in sorted(gp)],
                                  leaf_items(case["p"])):
        _close(g, want, f"grad {path}")
    if kind == "row":           # the replicated bias: the same on each
        np.testing.assert_array_equal(world[0][kind][1][0],
                                      world[1][kind][1][0])


def test_vocab_parallel_embed_unembed_nll_match_jax(world):
    import jax
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    case = _inputs()["vocab"]
    ids = jnp.asarray(case["ids"])
    y, (gt,) = _jax_vjp(lambda p: jlayers.embed(p, ids, jnp.float32),
                        case["p"], case["cy"])
    lg, (gtu, gxu) = _jax_vjp(
        lambda p, x: jlayers.unembed(p, x, jnp.float32), case["p"],
        case["x"], case["cl"])

    def nll(p, x):
        logp = jax.nn.log_softmax(jlayers.unembed(p, x, jnp.float32), -1)
        return -jnp.take_along_axis(logp, jnp.asarray(case["labels"])[
            ..., None], -1)[..., 0]
    nl, (gtn, gxn) = _jax_vjp(nll, case["p"], case["x"], case["cn"])
    lay = _layout(_table_shapes())
    for r, res in enumerate(world):
        _close(res["embed"][0], y, "embed")
        _close(res["unembed"][0], lg[..., lay.block(0, r)[0]], "logits")
        _close(res["unembed"][2], gxu, "unembed input grad")
        _close(res["nll"][0], nl, "nll")
        _close(res["nll"][2], gxn, "nll input grad")
    for key, want in (("embed", gt), ("unembed", gtu), ("nll", gtn)):
        (g,) = _whole(world, key, _table_shapes())
        _close(g, want["table"], f"{key} table grad")
    for key in ("embed", "nll"):
        np.testing.assert_array_equal(world[0][key][0], world[1][key][0])


@pytest.mark.parametrize("name", BLOCKS, ids=["-".join(b) for b in BLOCKS])
def test_parallel_block_matches_jax(name, world, block_params):
    """Attention (heads split, or qkv split mid-head and gathered) and the
    MLP (gated, plain with biases): output, parameter and input
    gradients against JAX's unsharded block."""
    import jax.numpy as jnp
    from repro.models import attention as jattn, mlp as jmlp
    kind, variant = name
    jcfg = _jax_cfg(kind, variant)
    np_p, x, cy = block_params[name]
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    fn = ((lambda p, x: jattn.attn_apply(p, x, jcfg, positions=pos))
          if kind == "attn" else (lambda p, x: jmlp.mlp_apply(p, x, jcfg)))
    y, (gp, gx) = _jax_vjp(fn, np_p, x, cy)
    cfg = (_attn_cfg if kind == "attn" else _mlp_cfg)(variant)
    shapes = transformer._block_shapes(cfg, "attn", 0)[
        "mixer" if kind == "attn" else "ffn"]
    lay = _layout(shapes)
    assert lay.is_split and all(d is not None for d, (p, _) in zip(
        lay.dims, leaf_items(shapes)) if p[-1] == "w")
    for res in world:
        _close(res[name][0], y, "output")
        _close(res[name][2], gx, "input grad")
    np.testing.assert_array_equal(world[0][name][0], world[1][name][0])
    for g, (path, want) in zip(_whole(world, name, shapes), leaf_items(gp)):
        _close(g, want, f"grad {path}")


@pytest.mark.parametrize("parts", [2, 4])
def test_tp_slice_then_unslice_is_the_identity(parts):
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    params = transformer.init_params(cfg, seed=3)
    mesh = Mesh((1, parts), ("data", "model"))
    lays = [transformer.tp_layout(cfg, mesh, resolve_rules(mesh), r)
            for r in range(parts)]
    assert lays[0].is_split and lays[0].parts == parts
    locals_ = [tp_slice(params, lay) for lay in lays]
    for lay, loc in zip(lays, locals_):
        assert [tuple(t.shape) for _, t in leaf_items(loc)] == list(
            lay.local.shapes)
    whole = tp_unslice(locals_, lays[0])
    for (pa, a), (pb, b) in zip(leaf_items(params), leaf_items(whole)):
        assert pa == pb
        np.testing.assert_array_equal(a.numpy(), b)


def _jax_annotations(jcfg):
    """``Counter`` of (per-layer shape, axes) of JAX's init's parameter
    ``shard`` calls (traced with ``eval_shape``: no weight is drawn).  The
    modules that import ``shard`` by name (``ssm``, ``rglru``, ``moe``)
    have their own reference to it, patched too."""
    import jax
    from repro.models import layers as jlayers, moe as jmoe
    from repro.models import rglru as jrglru, ssm as jssm
    from repro.models import transformer as jtransformer
    seen = Counter()
    orig = jlayers.shard
    owners = (jlayers, jssm, jrglru, jmoe)

    def record(x, axes):
        seen[tuple(x.shape), tuple(axes)] += 1
        return orig(x, axes)
    for m in owners:
        assert m.shard is orig
        m.shard = record
    try:
        jax.eval_shape(lambda k: jtransformer.init_params(k, jcfg),
                       jax.random.PRNGKey(0))
    finally:
        for m in owners:
            m.shard = orig
    return seen


LAYOUT_CASES = [(arch, smoke, rules) for arch in ARCHS
                for smoke in (False, True)
                for rules in (("default", "experts") if arch in MOE
                              else ("default",))]


@pytest.mark.parametrize("arch,smoke,rules", LAYOUT_CASES, ids=[
    f"{a}-{'smoke' if s else 'full'}-{r}" for a, s, r in LAYOUT_CASES])
def test_layout_is_jax_logical_spec_of_jax_annotations(arch, smoke, rules):
    """Every annotated leaf carries exactly the (shape, axes) JAX's init
    annotates (per layer: a stacked body leaf counts once a period), and
    its split dimension on (data 2, model 2) and (2, 4), under the
    default rules or the expert-parallel overrides, is where JAX's
    ``logical_spec`` puts ``model``; the other leaves replicate."""
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jget, reduce_for_smoke as jred
    from repro.dist.sharding import logical_spec as jspec
    from repro.dist.sharding import use_sharding as juse
    cfg, jcfg = get_config(arch), jget(arch)
    if smoke:
        cfg, jcfg = reduce_for_smoke(cfg), jred(jcfg)
    over = EP if rules == "experts" else None
    tree = transformer.param_shapes_tree(cfg)
    ours = Counter()
    for path, t in leaf_items(tree):
        if t.axes is None:
            continue
        if path[0] == "body":
            assert t.axes[0] is None
            ours[tuple(t.shape[1:]), t.axes[1:]] += t.shape[0]
        else:
            ours[tuple(t.shape), t.axes] += 1
    assert ours == _jax_annotations(jcfg)
    for shape in ((2, 2), (2, 4)):
        mesh = Mesh(shape, ("data", "model"))
        jm = AbstractMesh(shape, ("data", "model"))
        with juse(jm, over):
            from repro.dist.sharding import current_rules
            jrules = dict(current_rules())
        lay = transformer.tp_layout(cfg, mesh, resolve_rules(mesh, over))
        for (path, t), d in zip(leaf_items(tree), lay.dims):
            spec = (jspec(tuple(t.shape), t.axes, jm, jrules)
                    if t.axes is not None else (None,) * t.dim())
            want = [j for j, e in enumerate(spec) if e == "model"]
            assert [d] == want if want else d is None, (path, spec, d)


def _expected_dim(path, shape, lead, ep):
    """The dimension (from the end) the JAX rules split ``path`` over a
    ``model`` axis of 2 (``None``: replicated), by the leaf's role."""
    name, leaf = (path[-2] if len(path) > 1 else None), path[-1]
    if leaf == "table":
        dim = -2
    elif leaf == "r":                       # sLSTM (4, H, dh, dh): heads
        dim = -3
    elif leaf == "lam":
        dim = -1
    elif leaf in ("w_up", "w_gate", "w_down"):
        if "shared" in path:
            dim = None if ep else (-1 if leaf != "w_down" else -2)
        else:
            dim = -3 if ep else (-1 if leaf != "w_down" else -2)
    elif leaf == "w" and len(shape) - lead == 3:   # mLSTM block-diagonal
        dim = -3
    elif leaf in ("w", "b") and name in ("wq", "wk", "wv", "up", "gate",
                                         "in_rec", "in_gate", "wx",
                                         "ff_up", "ff_gate"):
        dim = -1
    elif leaf == "w" and name in ("wo", "down", "out", "ff_down", "wif",
                                  "wr", "wi"):
        dim = -2
    else:                                   # norms, convs, router, frontend
        dim = None
    return None if dim is None or shape[dim] % 2 else len(shape) + dim


@pytest.mark.parametrize("arch", ARCHS[:1] + ARCHS[2:3] + ARCHS[6:])
def test_moe_recurrent_and_frontend_configs_split_the_leaves_jax_puts_on_model(
        arch):
    """Each MoE, recurrent and frontend smoke configuration splits over
    ``model`` 2 exactly the leaves the JAX rules put there, leaf by leaf
    by its role: the banks' ``d_e`` (their experts under the
    expert-parallel overrides, the shared banks then whole), the
    recurrent state widths and the sLSTM's heads, attention, the MLPs
    and the tables; the router, the convs, the norms and the projector
    stay whole."""
    cfg = reduce_for_smoke(get_config(arch))
    mesh = Mesh((2, 2), ("data", "model"))
    tree = transformer.param_shapes_tree(cfg)
    for ep in ((False, True) if arch in MOE else (False,)):
        lay = transformer.tp_layout(cfg, mesh, resolve_rules(
            mesh, EP if ep else None))
        assert lay.is_split
        for (path, t), d in zip(leaf_items(tree), lay.dims):
            lead = 1 if path[0] == "body" else 0
            assert d == _expected_dim(path, tuple(t.shape), lead, ep), (
                path, ep)


def test_param_layout_partitions_only_over_model():
    """Rules that map a parameter axis elsewhere raise; rules that drop
    ``vocab`` keep the table whole; ``resolve_rules`` is what
    ``use_sharding`` activates."""
    from repro_torch.dist import sharding
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    mesh = Mesh((2, 2), ("data", "model"))
    tree = transformer.param_shapes_tree(cfg)
    with sharding.use_sharding(mesh, {"vocab": None}):
        assert sharding.current_rules() == resolve_rules(mesh,
                                                         {"vocab": None})
        lay = param_layout(tree, mesh, sharding.current_rules(), 3)
    assert lay.index == 1 and lay.parts == 2
    for (path, _), d in zip(leaf_items(tree), lay.dims):
        if path[-1] == "table":
            assert d is None
    with pytest.raises(NotImplementedError, match="only the model axis"):
        param_layout(tree, mesh, resolve_rules(mesh, {"mlp": "data"}))
