"""Port parity: the activations (``repro_torch.models.activations``)
against JAX's on the CPU, and the blocks that apply them at bf16.

* **bf16, every finite value** (65,280 of them): ``sigmoid``, ``silu``,
  ``gelu`` (tanh form), ``softplus``, ``log_sigmoid`` and ``tanh``
  against ``jax.nn``'s / ``jnp.tanh`` under ``jax.jit``, bit for bit.
  The only values that differ are those where XLA's CPU program flushes
  a subnormal to zero (it runs with denormals flushed; torch keeps them,
  on the CPU as on the card): a subnormal input (254 bf16 values), or a
  JAX result of zero where the port's value went through a subnormal and
  came out below 2^-118 (:data:`FLUSH_BELOW`; sigmoid, softplus and silu
  near -88, silu and gelu of inputs below ~2.4e-38).  Any other
  difference fails, and a flushed value must lie in one of those two
  zones.  ``F.silu`` and its kin, which compute in fp32 and round once,
  differ on about 1.9k values (silu; :data:`ONE_ROUNDING`).
* **fp32, a seeded sample** of 210,000 values (normal sigma 4, uniform on
  [-100, 100], normal sigma 1e-3): within :data:`F32_ULPS` ulps of
  JAX's result, plus, for gelu, ``GELU_ABS * |x|``, or flushed as above.
  The two libraries' fp32 ``exp`` / ``tanh`` / ``log1p`` are different
  approximations (XLA's polynomials, torch's vectorised ones), each
  within an ulp or two of the true value: a few ulps after the
  composition (4 is the largest reading).  gelu's ``1 + tanh(u)`` cancels
  for large negative x, where tanh's 1-ulp difference near -1 (2^-24)
  becomes an absolute error of about ``2^-24 |x|`` of a result far
  smaller than that.
* **gradients**, fp32, against ``jax.grad``: JAX's rules, finite where
  ``exp(-x)`` overflows; bf16, every finite value, against ``jax.vmap(
  jax.grad(f))`` and against ``jax.vjp`` with a seeded cotangent, bit for
  bit apart from the flushes (torch's own ``tanh`` backward and its
  autograd through gelu's primitives differ on ~870 values each).
* **a bf16 block backward**, the MLP's input gradient (smollm-360m's
  gated silu, musicgen-medium's plain gelu): the activation stage's
  backward equals JAX's bit for bit; the input gradient differs,
  because XLA's CPU program feeds the *unrounded* fp32 product of that
  stage into the transposed product (it drops a bf16 rounding that a
  conversion to fp32 follows), where the port, as a bf16 op does on the
  card, rounds it first.  So the port's input gradient is held to the
  correctly rounded product of its (JAX-equal) cotangents, and to JAX's
  within the shares and ulps of :data:`BLOCK_GRADS`.
* **bf16 blocks at smoke shapes**, JAX's weights carried across, against
  JAX's under ``jax.jit``: the gated MLP (smollm-360m), the MoE expert FFN
  (deepseek-moe-16b), the mLSTM and sLSTM blocks (xlstm-1.3b), the RG-LRU
  block (recurrentgemma-9b) and the frontend projector
  (phi-3-vision-4.2b).  The products accumulate in fp32 in another
  order than XLA's, so an output can round one bf16 ulp the other way,
  and a recurrence carries that on: each block is held to its share of
  equal elements and its largest gap in bf16 ulps (:data:`BLOCKS`, with
  the readings that set them).  JAX's mLSTM runs with its block-diagonal
  q / k / v product in fp32 (:func:`_with_f32_blockdiag`): XLA's CPU
  runtime cannot run that batched bf16 dot.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import activations
from repro_torch.weights import map_tree

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TINY = float(np.finfo(np.float32).tiny)      # the smallest normal, bf16's too
# a value JAX's flushed program gives as zero where the port's went
# through a subnormal comes out below this (silu(-88.5) = -3.2e-37)
FLUSH_BELOW = 2.0 ** -118
F32_ULPS = 4
GELU_ABS = 2.0 ** -22
GRAD_ULPS, GRAD_ABS = 8, 2.0 ** -21
JAX_ACTS = {"sigmoid": jax.nn.sigmoid, "silu": jax.nn.silu,
            "gelu": jax.nn.gelu, "softplus": jax.nn.softplus,
            "log_sigmoid": jax.nn.log_sigmoid, "tanh": jnp.tanh}
# torch's one-rounding functions: the port's before the repair
ONE_ROUNDING = {"sigmoid": torch.sigmoid, "silu": F.silu,
                "gelu": lambda x: F.gelu(x, approximate="tanh"),
                "softplus": F.softplus, "log_sigmoid": F.logsigmoid,
                "tanh": torch.tanh}


def _all_bf16():
    """Every finite bf16 value, as (numpy bf16, torch bf16, float32)."""
    xb = np.arange(1 << 16, dtype=np.uint16).view(ml_dtypes.bfloat16)
    xb = xb[np.isfinite(xb.astype(np.float32))]
    xt = torch.from_numpy(xb.view(np.int16).copy()).view(torch.bfloat16)
    return xb, xt, xb.astype(np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _flushed(x, want, got) -> np.ndarray:
    """Where JAX's flushed program explains a difference: a subnormal
    input, or JAX's zero against the port's value below FLUSH_BELOW."""
    return ((x != 0) & (np.abs(x) < TINY)) | (
        (want == 0) & (np.abs(got) < FLUSH_BELOW))


def _classify(x, want_bits, got_bits) -> dict:
    """The values on which two bf16 results differ (NaN equal to NaN):
    ``flushed`` (:func:`_flushed`, with their inputs) and ``other``."""
    w = want_bits.view(ml_dtypes.bfloat16).astype(np.float32)
    g = got_bits.view(ml_dtypes.bfloat16).astype(np.float32)
    differ = (want_bits != got_bits) & ~(np.isnan(w) & np.isnan(g))
    flushed = differ & _flushed(x, w, g)
    return {"flushed": x[flushed], "other": x[differ & ~flushed]}


@pytest.fixture(scope="module")
def bf16_values():
    xb, xt, x = _all_bf16()
    want = {n: np.asarray(jax.jit(f)(jnp.asarray(xb))).view(np.uint16)
            for n, f in JAX_ACTS.items()}
    return xt, x, want


@pytest.mark.parametrize("name", sorted(JAX_ACTS))
def test_bf16_every_value_equals_jax(bf16_values, name):
    xt, x, want = bf16_values
    got = _classify(x, want[name], _bits(getattr(activations, name)(xt)))
    assert got["other"].size == 0, (
        f"{name}: {got['other'].size} values differ from JAX's for no "
        f"flush, e.g. {got['other'][:8]}")
    # the two zones where a subnormal arises: tiny inputs, and the
    # exponentials' underflow near |x| = 88
    a = np.abs(got["flushed"])
    assert ((a < 2.0 ** -124) | ((a > 86) & (a < 104))).all(), \
        got["flushed"]
    assert got["flushed"].size <= 520


@pytest.mark.parametrize("name", ["silu", "gelu", "sigmoid", "softplus"])
def test_bf16_one_rounding_differs_from_jax(bf16_values, name):
    """The functions the port called before (fp32 inside, one rounding)
    differ from JAX's on far more values than the flushes explain: the
    fault the module repairs (1,866 values for silu with JAX 0.9)."""
    xt, x, want = bf16_values
    got = _classify(x, want[name], _bits(ONE_ROUNDING[name](xt)))
    assert got["other"].size > 500, got["other"].size


@pytest.mark.parametrize("name", sorted(JAX_ACTS))
def test_fp32_sample_within_ulps_of_jax(name):
    rng = np.random.default_rng(17)
    x = np.concatenate([rng.normal(0, 4, 100_000),
                        rng.uniform(-100, 100, 100_000),
                        rng.normal(0, 1e-3, 10_000)]).astype(np.float32)
    want = np.asarray(jax.jit(JAX_ACTS[name])(jnp.asarray(x)))
    got = getattr(activations, name)(torch.from_numpy(x)).numpy()
    tol = F32_ULPS * np.spacing(np.abs(want)) + (
        GELU_ABS * np.abs(x) if name == "gelu" else 0.0)
    bad = (np.abs(got - want) > tol) & ~_flushed(x, want, got)
    assert not bad.any(), (name, x[bad][:5], got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("name", ["sigmoid", "silu", "softplus",
                                  "log_sigmoid", "gelu", "tanh"])
def test_gradients_follow_jax_rules(name):
    """JAX's derivative rules (``lax.logistic``'s ``s * (1 - s)``,
    ``logaddexp``'s ``exp(x - out)`` with infinities replaced by 0), fp32,
    against ``jax.grad``: finite where ``exp(-x)`` overflows (x = -100,
    -1e4), and within GRAD_ULPS ulps of the larger magnitude plus
    ``GRAD_ABS * max(1, |x|)`` (or flushed): ``1 - s`` and ``1 - tanh^2``
    cancel, turning the libraries' 1-ulp differences of ``s`` and ``tanh``
    near 1 into absolute errors of a few 2^-24, which gelu's derivative
    scales by ``|x|``."""
    x = np.array([-1e4, -100.0, -88.5, -20.0, -3.0, -0.5, 0.0, 0.25, 1.5,
                  7.0, 30.0, 100.0, 1e4], np.float32)
    want = np.asarray(jax.vmap(jax.grad(JAX_ACTS[name]))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    getattr(activations, name)(xt).sum().backward()
    got = xt.grad.numpy()
    assert np.isfinite(got).all()
    mag = np.maximum(np.abs(got), np.abs(want))
    tol = GRAD_ULPS * np.spacing(mag) + GRAD_ABS * np.maximum(1, np.abs(x))
    bad = (np.abs(got - want) > tol) & ~_flushed(x, want, got)
    assert not bad.any(), (name, x[bad], got[bad], want[bad])


@pytest.fixture(scope="module")
def bf16_cotangent():
    """A seeded bf16 cotangent, one for each finite bf16 value."""
    _, xt, _ = _all_bf16()
    g = np.random.default_rng(3).normal(size=xt.shape).astype(
        ml_dtypes.bfloat16)
    return g, torch.from_numpy(g.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("cotangent", ["ones", "seeded"])
@pytest.mark.parametrize("name", sorted(JAX_ACTS))
def test_bf16_gradient_every_value_equals_jax(bf16_values, bf16_cotangent,
                                               name, cotangent):
    """The bf16 backward, as the main path runs it, against JAX's under
    ``jax.jit`` at every finite bf16 value: ``jax.vmap(jax.grad(f))``
    (cotangent 1) and ``jax.vjp`` with a seeded cotangent (which fixes
    how the rules associate ``g`` with their factors); the same bits but
    where XLA's CPU flushes a subnormal, as for the forward."""
    xt, x, _ = bf16_values
    f = JAX_ACTS[name]
    if cotangent == "ones":
        want = jax.jit(jax.vmap(jax.grad(f)))(
            jnp.asarray(x, jnp.bfloat16))
        g = torch.ones_like(xt)
    else:
        gb, g = bf16_cotangent
        want = jax.jit(lambda a, c: jax.vjp(f, a)[1](c)[0])(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(gb))
    t = xt.clone().requires_grad_(True)
    getattr(activations, name)(t).backward(g)
    got = _classify(x, np.asarray(want).view(np.uint16), _bits(t.grad))
    assert got["other"].size == 0, (
        f"{name}: {got['other'].size} gradients differ from JAX's for no "
        f"flush, e.g. at {got['other'][:8]}")
    a = np.abs(got["flushed"])
    assert ((a < 2.0 ** -124) | ((a > 86) & (a < 104))).all(), \
        got["flushed"]
    assert got["flushed"].size <= 20


@pytest.mark.parametrize("name", ["gelu", "tanh"])
def test_bf16_torch_autograd_differs_from_jax(bf16_values, name):
    """torch's own backward of ``tanh`` (``g * (1 - t * t)``) and its
    autograd through gelu's primitives (``(x * x) * x`` differentiated as
    two products) round otherwise than JAX's rules on ~870 bf16 values:
    what the module's ``_Tanh`` / ``_Gelu`` repair."""
    xt, x, _ = bf16_values
    want = jax.jit(jax.vmap(jax.grad(JAX_ACTS[name])))(
        jnp.asarray(x, jnp.bfloat16))
    t = xt.clone().requires_grad_(True)
    if name == "tanh":
        y = torch.tanh(t)
    else:
        c1 = activations.rounded(activations.GELU_C1, torch.bfloat16)
        c2 = activations.rounded(activations.GELU_C2, torch.bfloat16)
        y = t * ((torch.tanh((t + (t * t) * t * c1) * c2) + 1) * 0.5)
    y.sum().backward()
    got = _classify(x, np.asarray(want).view(np.uint16), _bits(t.grad))
    assert got["other"].size > 500, got["other"].size


def test_constants_are_rounded_as_xla_holds_them():
    """gelu's constants in bf16, as the compiled CPU program prints them."""
    assert activations.rounded(activations.GELU_C1, torch.bfloat16) \
        == float(ml_dtypes.bfloat16(0.044715)) == 0.044677734375
    assert activations.rounded(activations.GELU_C2, torch.bfloat16) \
        == 0.796875
    assert activations.rounded(activations.GELU_C1, torch.float32) \
        == float(np.float32(0.044715))


# ---------------------------------------------------------------------------
# blocks at bf16
# ---------------------------------------------------------------------------

# block -> (least share of equal elements, largest gap in bf16 ulps).
# Readings (JAX 0.9, torch 2.13, CPU): mlp, moe_expert, slstm and
# projector 100 % equal; rglru 99.989 %, 1 ulp; mlstm 99.84 %, 2 ulps (its
# exponential gates carry a 1-ulp flip of a product on).  Without the
# repair (``F.silu`` and kin) the MoE expert FFN of deepseek's smoke shapes
# differs in 61 % of its outputs; the mLSTM with its gate product reading
# the rounded silu (``ssm`` module docstring) in 35 %, up to 372 ulps.
BLOCKS = {
    "mlp": (0.999, 1.0),
    "moe_expert": (0.999, 1.0),
    "mlstm": (0.995, 2.0),
    "slstm": (0.999, 1.0),
    "rglru": (0.999, 1.0),
    "projector": (0.999, 1.0),
}


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger magnitude."""
    mag = np.maximum(np.abs(got), np.abs(want))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7
    return np.abs(got - want) / np.exp2(exp)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _bf16(jcfg, tcfg):
    return (jcfg.replace(compute_dtype="bfloat16"),
            tcfg.replace(compute_dtype="bfloat16"))


def _cfgs(arch):
    return _bf16(jax_reduce(jax_get_config(arch)),
                 reduce_for_smoke(get_config(arch)))


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _with_f32_blockdiag(jssm, fn):
    """``fn()`` with JAX's block-diagonal q / k / v product taking its
    bf16 operands as fp32: XLA's CPU runtime has no batched bf16 x bf16
    -> fp32 dot ("Unsupported element type for DotThunk"), and a product
    of two bf16 values is exact in fp32, so only the order of the block's
    4-term fp32 sum can differ from the dot it stands for."""
    plain = jssm._blockdiag_apply

    def blockdiag(p, x, cdt):
        nb, bs, _ = p["w"].shape
        y = jnp.einsum("...nb,nbc->...nc", x.reshape(
            *x.shape[:-1], nb, bs).astype(cdt).astype(jnp.float32),
            p["w"].astype(cdt).astype(jnp.float32)).astype(cdt)
        return y.reshape(*x.shape[:-1], nb * bs)
    jssm._blockdiag_apply = blockdiag
    try:
        return fn()
    finally:
        jssm._blockdiag_apply = plain


def _block_outputs(block: str):
    """(port, JAX) outputs of ``block`` at bf16 as float32 numpy."""
    if block == "mlp":
        from repro.models import mlp as jmlp

        from repro_torch.models import mlp
        jcfg, tcfg = _cfgs("smollm-360m")
        jp = jax.tree.map(np.asarray, jmlp.mlp_init(jax.random.PRNGKey(1),
                                                   jcfg))
        x = _x(2, (2, 16, jcfg.d_model))
        want = jax.jit(lambda p, a: jmlp.mlp_apply(p, a, jcfg))(
            jp, jnp.asarray(x, jnp.bfloat16))
        got = mlp.mlp_apply(map_tree(_t, jp), _t(x).bfloat16(), tcfg)
    elif block == "moe_expert":
        from repro.models import moe as jmoe

        from repro_torch.models import moe
        jcfg, tcfg = _cfgs("deepseek-moe-16b")
        E, C, d = 4, 8, jcfg.d_model
        de = jcfg.moe.d_expert or jcfg.d_ff
        ws = [_x(3 + i, s) * 0.05 for i, s in
              enumerate(((E, d, de), (E, d, de), (E, de, d)))]
        x = _x(6, (E, C, d))
        want = jax.jit(lambda *a: jmoe._expert_ffn(*a, jcfg))(
            *map(jnp.asarray, ws), jnp.asarray(x, jnp.bfloat16))
        got = moe._expert_ffn(*map(_t, ws), _t(x).bfloat16(), tcfg)
    elif block in ("mlstm", "slstm"):
        from repro.models import ssm as jssm

        from repro_torch.models import ssm
        jcfg, tcfg = _cfgs("xlstm-1.3b")
        init = {"mlstm": jssm.mlstm_block_init,
                "slstm": jssm.slstm_block_init}[block]
        jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(8), jcfg))
        x = _x(10, (2, 12, jcfg.d_model))
        if block == "mlstm":
            want = _with_f32_blockdiag(jssm, lambda: jax.jit(
                lambda p, a: jssm.mlstm_block_apply(p, a, jcfg, chunk=4)[0])(
                    jp, jnp.asarray(x, jnp.bfloat16)))
            got = ssm.mlstm_block_apply(map_tree(_t, jp), _t(x).bfloat16(),
                                        tcfg, chunk=4)[0]
        else:
            want = jax.jit(lambda p, a: jssm.slstm_block_apply(
                p, a, jcfg)[0])(jp, jnp.asarray(x, jnp.bfloat16))
            got = ssm.slstm_block_apply(map_tree(_t, jp), _t(x).bfloat16(),
                                        tcfg)[0]
    elif block == "rglru":
        from repro.models import rglru as jrglru

        from repro_torch.models import rglru
        jcfg, tcfg = _cfgs("recurrentgemma-9b")
        jp = jax.tree.map(np.asarray, jrglru.rglru_block_init(
            jax.random.PRNGKey(4), jcfg))
        x = _x(5, (2, 17, jcfg.d_model))
        want = jax.jit(lambda p, a: jrglru.rglru_block_apply(p, a, jcfg)[0])(
            jp, jnp.asarray(x, jnp.bfloat16))
        got = rglru.rglru_block_apply(map_tree(_t, jp), _t(x).bfloat16(),
                                      tcfg)[0]
    else:
        from repro.models import transformer as jt

        from repro_torch.models import transformer
        jcfg, tcfg = _cfgs("phi-3-vision-4.2b")
        jparams = jax.eval_shape(lambda k: jt.init_params(k, jcfg),
                                 jax.random.PRNGKey(0))
        fe = {k: {"w": _x(20 + i, v["w"].shape) * 0.05, **(
            {"b": _x(30 + i, v["b"].shape) * 0.05} if "b" in v else {})}
            for i, (k, v) in enumerate(sorted(jparams["frontend"].items()))}
        emb = _x(40, jparams["embed"]["table"].shape) * 0.02
        P = 6
        batch = {"tokens": np.arange(8, dtype=np.int32).reshape(2, 4),
                 "prefix_embeds": _x(41, (2, P, jcfg.d_frontend))}
        jp = {"frontend": fe, "embed": {"table": emb}}
        want = jax.jit(lambda p, b: jt._embed_inputs(p, b, jcfg)[0])(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})[:, :P]
        got = transformer._embed_inputs(
            map_tree(_t, jp), {"tokens": torch.from_numpy(batch["tokens"]),
                               "prefix_embeds": _t(batch["prefix_embeds"])},
            tcfg)[0][:, :P]
    return (got.detach().float().numpy(),
            np.asarray(jnp.asarray(want).astype(jnp.float32)))


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_bf16_block_matches_jax(block):
    got, want = _block_outputs(block)
    assert got.shape == want.shape
    equal = float((got == want).mean())
    worst = float(_ulps(got, want).max())
    least, most = BLOCKS[block]
    assert equal >= least and worst <= most, (
        f"{block}: {equal:.4%} of {got.size} elements equal, largest gap "
        f"{worst} bf16 ulps")



# arch -> (least share of the input gradient's elements equal to JAX's,
# largest gap in bf16 ulps).  Readings (JAX 0.9, torch 2.13, CPU):
# smollm-360m 59.3 %, 192 ulps; musicgen-medium 58.8 %, 323.5 ulps.  The
# cause, read on smollm's up product: JAX's transposed product equals the
# correctly rounded product of the *unrounded* stage cotangent (the fp32
# ``dh * silu(gate)``) in 99.96 % of its elements, the rest 1 ulp (fp32
# sum order); the rounded cotangent's product equals it in 58.4 %.  A gap
# of hundreds of ulps is an element near zero, where the sum of 512
# products cancels.
BLOCK_GRADS = {"smollm-360m": (0.55, 256.0),
               "musicgen-medium": (0.55, 384.0)}


@pytest.mark.parametrize("arch", sorted(BLOCK_GRADS))
def test_bf16_mlp_input_gradient_matches_jax(arch):
    """The MLP's bf16 backward at smoke shapes with a seeded cotangent,
    JAX's weights carried across.  (1) The activation stage (``up *
    act(gate)``, or ``act(up)``) turns JAX's cotangent at its output into
    JAX's at its inputs, bit for bit.  (2) The port's input gradient is the sum of the
    correctly rounded transposed products of its bf16 cotangents (float64
    here, each product rounded to bf16 as the port's is before the sum;
    at most 1 ulp and 99.9 % equal: fp32 sum order).  (3) Against
    JAX's input gradient: :data:`BLOCK_GRADS`.  XLA's CPU program skips
    the bf16 rounding of the stage's last product, which a conversion to
    fp32 for the product follows, so JAX's transposed product reads the
    unrounded cotangent (the module docstring); on the card, as in the
    port, a bf16 op rounds."""
    from repro.models import layers as jlayers
    from repro.models import mlp as jmlp

    from repro_torch.models import layers, mlp
    jcfg, tcfg = _cfgs(arch)
    bf, cdt = jnp.bfloat16, torch.bfloat16
    jp = jax.tree.map(np.asarray, jmlp.mlp_init(jax.random.PRNGKey(1), jcfg))
    x = _x(2, (2, 16, jcfg.d_model))
    g = _x(7, (2, 16, jcfg.d_model))
    act = JAX_ACTS[jcfg.act]
    ins = ["up", "gate"] if "gate" in jp else ["up"]

    def stage(*h):                      # the activation stage's inputs
        return h[0] * act(h[1]) if len(h) == 2 else act(h[0])

    def jax_parts(p, a, c):
        hs = [jlayers.linear(p[k], a, bf) for k in ins]
        h, vjp_stage = jax.vjp(stage, *hs)
        _, vjp_down = jax.vjp(lambda t: jlayers.linear(p["down"], t, bf), h)
        dh = vjp_down(c)[0]
        return dh, vjp_stage(dh)
    want_dh, want_stage = jax.jit(jax_parts)(jp, jnp.asarray(x, bf),
                                    jnp.asarray(g, bf))
    want = jax.jit(lambda p, a, c: jax.vjp(
        lambda a: jmlp.mlp_apply(p, a, jcfg), a)[1](c)[0])(
            jp, jnp.asarray(x, bf), jnp.asarray(g, bf))

    tp, gt = map_tree(_t, jp), _t(g).bfloat16()
    xt = _t(x).bfloat16().requires_grad_(True)
    mlp.mlp_apply(tp, xt, tcfg).backward(gt)
    got = xt.grad.float().numpy()
    # the block's stages by hand, to read the activation stage's cotangents
    xs = _t(x).bfloat16().requires_grad_(True)
    hs = [layers.linear(tp[k], xs, cdt) for k in ins]
    tact = activations.ACTS[tcfg.act]
    h = hs[0] * tact(hs[1]) if len(hs) == 2 else tact(hs[0])
    layers.row_linear(tp["down"], h, cdt).backward(gt, inputs=[xs, *hs],
                                               retain_graph=True)
    np.testing.assert_array_equal(xs.grad.float().numpy(), got)
    exact = sum(torch.from_numpy(t.grad.double().numpy() @ tp[k]["w"].to(
        cdt).double().numpy().T).to(cdt).float() for t, k in zip(hs, ins))
    exact = exact.to(cdt).float().numpy()
    dh = torch.from_numpy(np.array(want_dh.astype(jnp.float32))).to(cdt)
    for d, w in zip(torch.autograd.grad(h, hs, dh), want_stage):     # (1)
        np.testing.assert_array_equal(
            d.float().numpy(), np.asarray(w.astype(jnp.float32)))
    assert (got == exact).mean() >= 0.999 and \
        _ulps(got, exact).max() <= 1                                  # (2)
    want = np.asarray(want.astype(jnp.float32))          # (3)
    equal, worst = float((got == want).mean()), float(_ulps(got, want).max())
    least, most = BLOCK_GRADS[arch]
    assert equal >= least and worst <= most, (
        f"{arch}: {equal:.4%} of {got.size} input-gradient elements equal, "
        f"largest gap {worst} bf16 ulps")


# ---------------------------------------------------------------------------
# the activation kernel's entry points (csrc/activations.cu) seen from the
# CPU: the gated form, the dispatch, the operators' fakes and the layouts
# the launch reads.  The kernel itself runs on the card only
# (tests/test_torch_kernels_gpu.py, chip_smoke.py's activations phase).
# ---------------------------------------------------------------------------

def _bf16_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_gated_equals_jax_bit_for_bit(name):
    """``gated(name, up, gate)`` against JAX's ``up * act(gate)`` under
    ``jax.jit`` on a seeded bf16 sample, forward and both cotangents of a
    seeded bf16 cotangent: the same bits."""
    rng = np.random.default_rng(21)
    up, gate, cot = (rng.normal(0, s, 50_000).astype(ml_dtypes.bfloat16)
                     for s in (2.0, 4.0, 1.0))
    f = JAX_ACTS[name]
    want, vjp = jax.jit(lambda h, g: jax.vjp(lambda a, b: a * f(b), h, g))(
        jnp.asarray(up), jnp.asarray(gate))
    want_up, want_gate = jax.jit(vjp)(jnp.asarray(cot))
    tu, tg = (_bf16_torch(a).requires_grad_(True) for a in (up, gate))
    got = activations.gated(name, tu, tg)
    got.backward(_bf16_torch(cot))
    for g, w in ((got.detach(), want), (tu.grad, want_up),
                 (tg.grad, want_gate)):
        np.testing.assert_array_equal(_bits(g), np.asarray(w).view(np.uint16))


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """Every public function, forward and backward, on CPU tensors runs
    the composition: no launch is attempted and no counter moves."""
    from repro_torch.kernels.activations import kernel as K

    def launched(*a, **kw):
        raise AssertionError("a CPU tensor reached the kernel's launch")
    monkeypatch.setattr(K, "_run", launched)
    before = dict(K.launches)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.linspace(-6, 6, 97).to(dtype).requires_grad_(True)
        for name in JAX_ACTS:
            getattr(activations, name)(x).sum().backward()
            activations.gated(name, x * 1, x).sum().backward()
    assert K.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_operator_fakes_give_shape_and_dtype(dtype):
    """Under ``FakeTensorMode`` on ``cuda`` (as ``launch.dryrun`` traces)
    each operator's fake gives its outputs' shape, dtype and device, and
    the public forwards reach the operators."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.activations import kernel as K
    shape = (3, 5, 16)
    with FakeTensorMode():
        x = torch.empty(shape, dtype=dtype, device="cuda")
        outs = [K.act_op(x, "gelu"), K.act_gated_op(x, x, "silu"),
                K.act_grad_op(x, None, x, "sigmoid"),
                K.act_grad_op(x, x, x, "softplus"),
                *K.act_gated_grad_op(x, x, x, "tanh"),
                activations.log_sigmoid(x), activations.gated("gelu", x, x)]
    for y in outs:
        assert (tuple(y.shape), y.dtype, y.device.type) == (shape, dtype,
                                                            "cuda")


def test_kernel_refuses_what_it_does_not_take():
    from repro_torch.kernels.activations import kernel as K
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        K.act(x, "silu")
    with pytest.raises(ValueError, match="no function"):
        K.act(x, "relu")
    with pytest.raises(ValueError, match="differ"):
        activations.gated("silu", x, x[:4])
    with pytest.raises(ValueError, match="reads"):
        K.act_grad(x, None, x, "silu")


@pytest.mark.parametrize("case", ["contiguous", "slstm_gate", "chunk",
                                  "transposed", "expanded_rows",
                                  "scalar"])
def test_rows_view_reads_the_call_sites_views(case):
    """The (rows, cols, row stride) the launch reads a strided input as:
    the sLSTM's ``g[:, k]`` and the RG-LRU's ``.chunk`` in place; a
    transposed view is none (it is copied first)."""
    from repro_torch.kernels.activations.kernel import rows_view
    g = torch.zeros(4, 4, 3, 8)
    c = torch.zeros(2, 5, 12)
    t, want = {
        "contiguous": (g, (1, 384, 384)),
        "slstm_gate": (g[:, 2], (4, 24, 96)),
        "chunk": (c.chunk(2, dim=-1)[1], (10, 6, 12)),
        "transposed": (g[0].transpose(0, 1), None),
        "expanded_rows": (torch.zeros(1, 8).expand(5, 8), (5, 8, 0)),
        "scalar": (torch.zeros(()), (1, 1, 1))}[case]
    assert rows_view(t) == want
    if want is not None:
        rows, cols, stride = want
        base = t.storage_offset()
        idx = torch.arange(rows)[:, None] * stride + torch.arange(cols)
        flat = torch.arange(t.untyped_storage().nbytes() // 4,
                            dtype=torch.float32)
        view = flat.as_strided(t.shape, t.stride(), base)
        np.testing.assert_array_equal(view.reshape(-1).numpy(),
                                      flat[base + idx.reshape(-1)].numpy())


def test_layout_shares_rows_and_copies_other_views():
    """One (rows, cols) for all of a launch's inputs: a contiguous input
    takes a strided one's rows; a view of other rows is copied, and the
    copy is what the launch reads."""
    from repro_torch.kernels.activations.kernel import _layout
    c = torch.arange(2 * 5 * 12, dtype=torch.float32).reshape(2, 5, 12)
    hi = c.chunk(2, dim=-1)[1]
    flat = torch.zeros(2, 5, 6)
    rows, cols, strides, ins = _layout((flat, hi, None), hi.numel())
    assert (rows, cols, strides) == (10, 6, [6, 12, 0])
    assert ins[1] is hi and ins[2] is None
    tr = c[0].t()[:6]                     # (6, 5), no stack of rows
    h0 = hi[0]
    rows, cols, strides, ins = _layout((tr, h0, None), 30)
    assert (rows, cols, strides) == (5, 6, [6, 12, 0])
    assert ins[0].is_contiguous() and torch.equal(ins[0], tr)
    assert ins[1] is h0
    rows, cols, strides, ins = _layout((flat, flat, flat), 60)
    assert (rows, cols, strides) == (1, 60, [60, 60, 60])


@pytest.mark.parametrize("name", ["shipped", "ieee_divide", "no_rounding",
                                  "copy"])
def test_act_probe_patches_match_the_source(name):
    """``launch/act_probe.py`` builds its variants by patching the shipped
    ``csrc/activations.cu``: each patch target occurs exactly once."""
    from repro_torch.kernels import _build
    from repro_torch.launch import act_probe
    assert set(act_probe.PATCHES) == {"shipped", "ieee_divide",
                                      "no_rounding", "copy"}
    source = (_build.CSRC / "activations.cu").read_text()
    out = act_probe.patched(name, source)
    assert (out == source) == (name == "shipped")
