"""RG-LRU recurrent block, RecurrentGemma / Griffin, arXiv:2402.19427
(port of ``repro/models/rglru.py``).

Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_r x_t)                      (recurrence gate)
    i_t = sigmoid(W_i x_t)                      (input gate)
    log a_t = -c * softplus(Lambda) * r_t       (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence runs as a log-depth scan over the sequence
(:func:`linear_scan`: ceil(log2 S) rounds of the ``(a1 a2, a2 b1 + b2)``
combine, where the JAX package calls ``jax.lax.associative_scan``); a
carried state h0 is folded in afterwards as ``h + a_cum h0``.  The
recurrence and its ``W_r`` / ``W_i`` products are fp32 whatever the
compute dtype.  The block wraps the RG-LRU between an input projection
(two branches: recurrent and GeLU gate, Griffin-style), a short causal
depthwise conv on the recurrent branch, and an output projection.  Plain
tensor code on either device.  Under tensor parallelism (the training
forward's ``tp``) the ``state`` axis (``d_rnn``) splits over the group:
:func:`rglru_block_apply`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import conv_apply, conv_block, conv_shapes

_C = 8.0


def rglru_shapes(d_rnn: int, *, lead: tuple = ()) -> dict:
    """``rglru_init``'s leaves with its logical axes: Lambda (d_rnn,)
    (``("state",)``), W_r and W_i (d_rnn, d_rnn) (``("state",
    "state")``: the rows split, the second use of ``model`` stays
    unconstrained)."""
    state = ("state", "state")
    return {"lam": layers.meta(*lead, d_rnn,
                               axes=(None,) * len(lead) + ("state",)),
            "wr": layers.linear_shapes(d_rnn, d_rnn, lead=lead, axes=state),
            "wi": layers.linear_shapes(d_rnn, d_rnn, lead=lead, axes=state)}


def lam_init_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``rglru_init``'s law for Lambda, in place: u ~ U(0.9, 0.999) and
    Lambda = log(expm1(-log u)), the inverse softplus of -log u, so that
    a = u^c at r = 1 (the paper's App. A)."""
    u = t.uniform_(0.9, 0.999, generator=gen)
    return u.copy_(torch.log(torch.expm1(-torch.log(u))))


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1,
    in ceil(log2 S) rounds (Hillis-Steele).  Returns (a_cum, h): a_cum_t
    the product a_0 ... a_t, h_t the state."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def rglru_apply(p, x: torch.Tensor, h0=None, tp=None):
    """x: (B, S, d_rnn), computed in fp32; h0: (B, d_rnn).  Returns
    (y (B, S, d_rnn) fp32, h_last (B, d_rnn)).  With ``tp`` ``x``, ``h0``,
    Lambda and the result are the rank's block of channels, W_r / W_i its
    rows: the fp32 products are row-parallel, ``r`` and ``i`` summed whole
    over the group (one sum for both) and cut to the rank's block, and
    the scan runs on the rank's channels with no collective."""
    x = x.float()
    f32 = torch.float32
    if tp is None:
        r = torch.sigmoid(layers.linear(p["wr"], x, f32))
        i = torch.sigmoid(layers.linear(p["wi"], x, f32))
    else:
        ri = tp.split_groups(tp.reduce(torch.cat(
            [layers.linear(p["wr"], x, f32), layers.linear(p["wi"], x, f32)],
            dim=-1)), 2)
        r, i = torch.sigmoid(ri).chunk(2, dim=-1)
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x)
    a_cum, h = linear_scan(a, gated)
    if h0 is not None:
        h = h + a_cum * h0[:, None, :]
    return h, h[:, -1, :]


def rglru_block_shapes(cfg: ModelConfig, *, lead: tuple = ()) -> dict:
    """``rglru_block_init``'s leaves with its logical axes: in_rec and
    in_gate (d, d_rnn) (``("embed", "state")``), the conv over d_rnn (no
    axes), the RG-LRU and out (d_rnn, d) (``("state", "embed")``); no
    biases."""
    d = cfg.d_model
    d_rnn = cfg.rglru_width or d
    col = ("embed", "state")
    return {
        "in_rec": layers.linear_shapes(d, d_rnn, lead=lead, axes=col),
        "in_gate": layers.linear_shapes(d, d_rnn, lead=lead, axes=col),
        "conv": conv_shapes(cfg.conv_width, d_rnn, lead=lead),
        "rglru": rglru_shapes(d_rnn, lead=lead),
        "out": layers.linear_shapes(d_rnn, d, lead=lead,
                                    axes=("state", "embed")),
    }


def rglru_block_apply(p, x: torch.Tensor, cfg: ModelConfig, state=None,
                      tp=None):
    """x: (B, S, d) -> (y, state).  state = (h_last, conv_state) or None.

    With ``tp`` where the rank holds a block of ``d_rnn``: in_rec / in_gate
    column-parallel; in the training forward (no ``state``) the recurrent
    branch gathered whole for the conv (replicated, so its gradient is
    the same on every rank) and cut back to the rank's channels after it;
    in a decode (``state`` the rank's block, ``transformer.init_caches``)
    the conv runs on the rank's channels with their state
    (:func:`repro_torch.models.ssm.conv_block`); the RG-LRU on those
    channels (:func:`rglru_apply`); out row-parallel."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    if tp is not None and p["in_rec"]["w"].shape[-1] == (cfg.rglru_width
                                                          or cfg.d_model):
        tp = None                     # d_rnn replicated: a plain block
    h0, conv_state = state if state is not None else (None, None)
    xin = tp.copy(x) if tp is not None else x
    rec = layers.linear(p["in_rec"], xin, cdt)
    gate = layers.ACTS["gelu"](layers.linear(p["in_gate"], xin, cdt))
    if tp is not None and state is not None:
        rec, conv_state = conv_apply(conv_block(p["conv"], tp), rec,
                                     conv_state)
    else:
        if tp is not None:
            rec = tp.gather_cat(rec)
        rec, conv_state = conv_apply(p["conv"], rec, conv_state)
        if tp is not None:
            rec = tp.split(rec)
    h, h_last = rglru_apply(p["rglru"], rec, h0, tp)
    y = layers.row_linear(p["out"], h.to(cdt) * gate, cdt, tp)
    return y, (h_last, conv_state)
