"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential), Beck et al., arXiv:2405.04517 (port of
``repro/models/ssm.py``).

mLSTM is a linear-attention-style cell with exponential gating:

    C_t = f_t C_{t-1} + i_t k_t v_t^T,   n_t = f_t n_{t-1} + i_t k_t,
    h_t = (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t)),

stabilised by the running log-scale m_t (the gates live in log space).  It
runs **chunkwise**: within a chunk of c steps the contributions are a
(c x c) masked parallel form, across chunks a Python loop carries
(C, n, m).  The chunk-end update of C is (w * k)^T v, one matmul: the
(B, H, c, dk, dv) outer products are never formed (at xlstm-1.3b's width
dk = dv = 1024).  ``mlstm_sequential`` is the step-by-step oracle.

sLSTM has per-unit scalar memory with recurrent gate connections
(block-diagonal per head), which makes it inherently sequential: a Python
loop over the steps, ~20 operator calls each.

The JAX package's ``*_init`` functions become ``*_shapes`` (the leaves as
``meta`` tensors, optionally stacked behind ``lead`` axes) and per-leaf
laws drawn by ``transformer.init_params`` in canonical order: truncated
normal with fan-in the unstacked leaf's first axis for every ``w`` and
``r`` (``repro/models/layers.py:19``; for the (nb, 4, 4) q / k / v blocks
that is nb, for sLSTM's (4, H, dh, dh) ``r`` it is 4), and
:func:`conv_init_` for the conv's ``w``.

Numerics follow the JAX package: the cell states, the mLSTM q / k / v and
gates and the sLSTM input projection are fp32 whatever the compute dtype;
the short conv's output takes the promoted dtype of its cached state and
its input, as ``jnp.concatenate`` gives it.  Every function is plain
tensor code on either device; none holds a kernel of its own.

Under tensor parallelism (``tp``) the ``state`` axis (``d_in``, the
gates' ``4 d``) and the sLSTM's heads split over the group as the JAX
package's axes say (:func:`mlstm_block_apply`, :func:`slstm_block_apply`);
in the training forward the convs and norms stay replicated and see whole
values, so their gradients are the same bits on every rank; in a decode
the convs run on the rank's channels with their state
(:func:`conv_block`).  The sLSTM's step loop runs on the rank's heads
with no collective inside; the mLSTM's heads run on every rank where
they do not divide over the group (``heads`` replicated, as the JAX
package's rules leave them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG = -1e30
MLSTM_QKV_BLOCK = 4   # official xLSTM qkv_proj_blocksize: block-diagonal qkv


# ---------------------------------------------------------------------------
# causal depthwise conv (short; used by mLSTM and RG-LRU blocks)
# ---------------------------------------------------------------------------

def conv_shapes(width: int, d: int, *, lead: tuple = ()) -> dict:
    return {"w": layers.meta(*lead, width, d), "b": layers.meta(*lead, d)}


def conv_init_(t: torch.Tensor, gen: torch.Generator,
               width: int | None = None) -> torch.Tensor:
    """``conv_init``'s law for ``w`` (..., width, d), in place: N(0, 1) /
    width, not truncated.  ``width`` is given where ``t`` is a flat block
    of the leaf."""
    return t.normal_(generator=gen).mul_(1.0 / (width or t.shape[-2]))


def conv_apply(p, x: torch.Tensor, state=None):
    """x: (B, S, d).  state: (B, width - 1, d) trailing context for decode.
    Returns (y, new_state), both in the promoted dtype of state and x."""
    w = p["w"].to(x.dtype)
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)
    S = x.shape[1]
    y = w[0] * xp[:, width - 1:width - 1 + S]
    for j in range(1, width):
        y = y + w[j] * xp[:, width - 1 - j:width - 1 - j + S]
    y = y + p["b"].to(x.dtype)
    return y, xp[:, xp.shape[1] - (width - 1):]


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------

def _mlstm_chunk(q, k, v, li, lf, state):
    """One chunk, parallel form.  q, k: (B, H, c, dk), v: (B, H, c, dv),
    li / lf: (B, H, c) log input / forget gates.  state = (C, n, m)."""
    C, n, m = state                      # (B,H,dk,dv), (B,H,dk), (B,H)
    c = q.shape[2]
    a = torch.cumsum(lf, dim=-1)                      # (B,H,c) inclusive
    # D_ts = a_t - a_s + li_s  for s <= t
    D = a[..., :, None] - a[..., None, :] + li[..., None, :]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    D = torch.where(tri, D, torch.full_like(D, NEG))
    m_intra = D.amax(dim=-1)                          # (B,H,c)
    m_inter = a + m[..., None]                        # state carries scale m
    m_t = torch.maximum(m_intra, m_inter)

    dots = torch.matmul(q, k.transpose(-1, -2))       # (B,H,c,c)
    Wm = torch.exp(D - m_t[..., None]) * tri
    Wd = Wm * dots
    num = torch.matmul(Wd, v)
    den = Wd.sum(dim=-1)

    scale = torch.exp(m_inter - m_t)                  # (B,H,c)
    num = num + scale[..., None] * torch.matmul(q, C)
    den = den + scale * torch.matmul(q, n[..., None])[..., 0]

    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    # chunk-end state update
    a_c = a[..., -1]                                  # (B,H)
    m_new = torch.maximum(a_c + m, (a_c[..., None] - a + li).amax(dim=-1))
    w_state = torch.exp(a_c[..., None] - a + li - m_new[..., None])
    wk = w_state[..., None] * k                       # (B,H,c,dk)
    decay = torch.exp(a_c + m - m_new)
    C_new = decay[..., None, None] * C + torch.matmul(wk.transpose(-1, -2), v)
    n_new = decay[..., None] * n + wk.sum(dim=-2)
    return h, (C_new, n_new, m_new)


def mlstm_parallel(q, k, v, li, lf, state, *, chunk: int = 256):
    """Chunkwise mLSTM over a full sequence.  Shapes as in ``_mlstm_chunk``
    with sequence length S, padded to a chunk multiple (``li = NEG``,
    ``lf = 0``: padded steps add nothing and decay nothing).  Returns
    (h, final_state)."""
    S = q.shape[2]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, pad), value=NEG)
        lf = F.pad(lf, (0, pad))
    hs = []
    for s in range(0, q.shape[2], c):
        h, state = _mlstm_chunk(q[:, :, s:s + c], k[:, :, s:s + c],
                                v[:, :, s:s + c], li[..., s:s + c],
                                lf[..., s:s + c], state)
        hs.append(h)
    h = hs[0] if len(hs) == 1 else torch.cat(hs, dim=2)
    return h[:, :, :S], state


def mlstm_sequential(q, k, v, li, lf, state):
    """Step-by-step oracle for tests."""
    C, n, m = state
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt, lit, lft = (q[:, :, t], k[:, :, t], v[:, :, t],
                                li[..., t], lf[..., t])
        m_new = torch.maximum(lft + m, lit)
        fp = torch.exp(lft + m - m_new)
        ip = torch.exp(lit - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.matmul(qt[..., None, :], C)[..., 0, :]
        den = (qt * n).sum(dim=-1)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, dim=2), (C, n, m)


MLSTM_STATE_AXES = (("sub_batch", "heads", None, None),
                    ("sub_batch", "heads", None), ("sub_batch", "heads"))


def mlstm_state_init(batch: int, heads: int, dk: int, dv: int, *,
                     lead: tuple = (), device="cpu", local: bool = True):
    """(C, n, m) zeros, m = -1e30 (fp32); ``lead`` axes go in front.  C
    and n carry the JAX package's logical axes (``("sub_batch", "heads",
    None, None)`` / ``("sub_batch", "heads", None)``), m the same
    heads: under an active ``use_sharding`` the rank allocates its
    block (``dist.sharding.local_shape``) unless ``local`` is false (the
    sizes are then the block's already)."""
    from repro_torch.dist.sharding import local_shape
    f32 = torch.float32
    shapes = [local_shape(sh, ax) if local else sh for sh, ax in zip(
        ((batch, heads, dk, dv), (batch, heads, dk), (batch, heads)),
        MLSTM_STATE_AXES)]
    return (torch.zeros((*lead, *shapes[0]), dtype=f32, device=device),
            torch.zeros((*lead, *shapes[1]), dtype=f32, device=device),
            torch.full((*lead, *shapes[2]), -1e30, dtype=f32,
                       device=device))


def conv_block(p, tp):
    """The rank's channels of the depthwise conv ``p`` (its block of the
    last dimension): a decode under tensor parallelism runs the conv on
    the rank's channels with their state (the conv's weights are
    replicated, each channel its own filter)."""
    def cut(t):
        k = t.shape[-1] // tp.parts
        return t[..., tp.index * k:(tp.index + 1) * k]
    return {"w": cut(p["w"]), "b": cut(p["b"])}


# ---------------------------------------------------------------------------
# mLSTM block (up-proj, conv, heads, gating, down-proj)
# ---------------------------------------------------------------------------

def mlstm_block_shapes(cfg: ModelConfig, *, lead: tuple = ()) -> dict:
    """``mlstm_block_init``'s leaves with its logical axes: up (d, 2 d_in)
    (``("embed", "state")``), the conv over d_in (no axes), block-diagonal
    q / k / v (d_in / 4, 4, 4) (``("state", None, None)``), the gates
    (d_in, 2 H) (``("state", None)``), an RMSNorm over d_in and down
    (d_in, d) (``("state", "embed")``); no biases."""
    d = cfg.d_model
    d_in = int(cfg.mlstm_proj_factor * d)
    H = cfg.num_heads
    bs = MLSTM_QKV_BLOCK
    none = (None,) * len(lead)

    def blockdiag():
        return {"w": layers.meta(*lead, d_in // bs, bs, bs,
                                 axes=none + ("state", None, None))}
    return {
        "up": layers.linear_shapes(d, 2 * d_in, lead=lead,
                                   axes=("embed", "state")),
        "conv": conv_shapes(cfg.conv_width, d_in, lead=lead),
        "wq": blockdiag(), "wk": blockdiag(), "wv": blockdiag(),
        "wif": layers.linear_shapes(d_in, 2 * H, lead=lead,
                                    axes=("state", None)),
        "norm": layers.norm_shapes(d_in, lead=lead),
        "down": layers.linear_shapes(d_in, d, lead=lead,
                                     axes=("state", "embed")),
    }


def _blockdiag_apply(p, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Block-diagonal linear: x (..., d) with (nb, bs, bs) blocks, operands
    in the compute dtype, fp32 accumulation, the result in the compute
    dtype."""
    nb, bs, _ = p["w"].shape
    xb = x.reshape(-1, nb, bs).to(cdt).transpose(0, 1)        # (nb, T, bs)
    y = torch.bmm(xb, p["w"].to(cdt))                         # (nb, T, bs)
    return y.transpose(0, 1).reshape(*x.shape[:-1], nb * bs)


def _mlstm_tp(p, tp):
    """``tp`` where the rank holds a block of ``d_in`` (``state``), else
    ``None``."""
    if tp is None or p["up"]["w"].shape[-1] == 2 * p["conv"]["w"].shape[1]:
        return None
    return tp


def _mlstm_qkvif(p, x: torch.Tensor, cfg: ModelConfig, conv_state,
                 tp=None):
    """q, k, v, the log gates, z and the conv state; with ``tp`` (see
    :func:`mlstm_block_apply`) q / k / v and the gates of the rank's heads
    where the heads divide over the group, else of every head; z whole."""
    B, S, _ = x.shape
    H = cfg.num_heads
    cdt = layers.dtype_of(cfg.compute_dtype)
    d_in = p["conv"]["w"].shape[1]
    if tp is None:
        up = layers.linear(p["up"], x, cdt)
    else:
        up = tp.gather_cat(layers.linear(p["up"], tp.copy(x), cdt))
    xm, z = up[..., :d_in], up[..., d_in:]
    dk = d_in // H
    if tp is None or conv_state is None:
        xc, conv_state = conv_apply(p["conv"], xm, conv_state)
        xc = F.silu(xc)
        if tp is not None:              # the rank's channels of both
            xc, xm = tp.split_groups(torch.cat([xc, xm.to(xc.dtype)],
                                               dim=-1), 2).chunk(2, dim=-1)
    else:                               # decode: the conv on its channels
        xm = tp.split(xm)
        xc, conv_state = conv_apply(conv_block(p["conv"], tp), xm,
                                    conv_state)
        xc = F.silu(xc)
    q = _blockdiag_apply(p["wq"], xc, cdt)
    k = _blockdiag_apply(p["wk"], xc, cdt)
    v = _blockdiag_apply(p["wv"], xm, cdt)
    ifg = layers.linear(p["wif"], xc, torch.float32)
    if tp is not None:
        ifg = tp.reduce(ifg)
        if H % tp.parts == 0:           # the rank's heads: its channels
            H //= tp.parts
            ifg = tp.split_groups(ifg, 2)
        else:                           # every head on every rank
            q, k, v = (tp.gather_cat(t) for t in (q, k, v))

    def heads(t):
        return t.reshape(B, S, H, dk).transpose(1, 2)
    q, k, v = heads(q).float(), heads(k).float() * dk ** -0.5, \
        heads(v).float()
    li = ifg[..., :H].transpose(1, 2)                 # (B,H,S) log input gate
    lf = F.logsigmoid(ifg[..., H:]).transpose(1, 2)
    return q, k, v, li, lf, z, conv_state


def mlstm_block_apply(p, x: torch.Tensor, cfg: ModelConfig, state=None, *,
                      chunk: int = 256, tp=None):
    """x: (B, S, d) -> (y, state).  state = (cell_state, conv_state) or
    None.

    With ``tp`` where the rank holds a block of ``d_in``: up
    column-parallel, its output gathered whole (rank 0's block is ``xm``,
    rank 1's ``z`` on 2 ranks); the conv on the whole ``xm`` (replicated;
    in a decode, with ``state``, on the rank's channels and their conv
    state); the rank's channels of ``xc`` and ``xm`` for its q / k / v
    blocks; the gates row-parallel, summed whole.  Where the heads divide
    over the group the rank's channels are its heads: the gates are cut to
    them and the cell runs on them, its output gathered whole; where they
    do not (xlstm-1.3b's 4 heads on 16 ranks) q, k and v are gathered
    whole and every head runs on every rank, as the JAX package's rules
    leave ``heads`` replicated there.  Then the norm over ``d_in`` and the
    ``z`` gate (replicated), and the rank's rows of down, row-parallel."""
    B, S, _ = x.shape
    tp = _mlstm_tp(p, tp)
    local = tp is not None and cfg.num_heads % tp.parts == 0
    H = cfg.num_heads // (tp.parts if local else 1)
    d_in = int(cfg.mlstm_proj_factor * cfg.d_model)
    dk = d_in // cfg.num_heads
    if state is None:
        cell, conv_state = mlstm_state_init(B, H, dk, dk, device=x.device,
                                            local=False), None
    else:
        cell, conv_state = state
        if cell[2].shape[-1] != H:
            raise ValueError(f"mLSTM: the state holds {cell[2].shape[-1]} "
                             f"heads, this layout runs {H}")
    q, k, v, li, lf, z, conv_state = _mlstm_qkvif(p, x, cfg, conv_state, tp)
    h, cell = mlstm_parallel(q, k, v, li, lf, cell, chunk=chunk)
    h = h.transpose(1, 2).reshape(B, S, H * dk).to(x.dtype)
    if local:
        h = tp.gather_cat(h)
    h = layers.apply_norm(p["norm"], h, "rmsnorm")
    h = h * F.silu(z.to(h.dtype))
    if tp is not None:
        h = tp.split(h)
    y = layers.row_linear(p["down"], h, layers.dtype_of(cfg.compute_dtype),
                          tp)
    return y, (cell, conv_state)


def mlstm_block_decode(p, x: torch.Tensor, cfg: ModelConfig, state,
                       tp=None):
    """One-token step: the chunkwise path with one step a chunk (exact);
    with ``tp`` on the rank's block of the state (:func:`mlstm_block_apply`,
    ``transformer.init_caches``)."""
    return mlstm_block_apply(p, x, cfg, state, chunk=1, tp=tp)


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def slstm_block_shapes(cfg: ModelConfig, *, lead: tuple = ()) -> dict:
    """``slstm_block_init``'s leaves with its logical axes: wx (d, 4 d)
    for z, i, f, o (``("embed", "state")``), the recurrent r (4, H, dh,
    dh) (``(None, "heads", None, None)``), an RMSNorm and the gated FFN
    of width int(slstm_proj_factor d) (``ff_up`` / ``ff_gate`` ``("embed",
    "mlp")``, ``ff_down`` ``("mlp", "embed")``); no biases."""
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    d_ff = int(cfg.slstm_proj_factor * d)
    return {
        "wx": layers.linear_shapes(d, 4 * d, lead=lead,
                                   axes=("embed", "state")),
        "r": layers.meta(*lead, 4, H, dh, dh, axes=(None,) * len(lead) + (
            None, "heads", None, None)),
        "norm": layers.norm_shapes(d, lead=lead),
        "ff_up": layers.linear_shapes(d, d_ff, lead=lead),
        "ff_gate": layers.linear_shapes(d, d_ff, lead=lead),
        "ff_down": layers.linear_shapes(d_ff, d, lead=lead,
                                        axes=("mlp", "embed")),
    }


SLSTM_STATE_AXES = ("sub_batch", "heads", None)


def slstm_state_init(batch: int, heads: int, dh: int, *, lead: tuple = (),
                     device="cpu", local: bool = True):
    """(c, n, m, h_prev): zeros, 1e-6, -1e30, zeros (fp32), each with the
    axes ``("sub_batch", "heads", None)``: under an active
    ``use_sharding`` the rank allocates its block, its rows and, where
    ``r``'s heads split, its heads (``dist.sharding.local_shape``),
    unless ``local`` is false (the sizes are then the block's already)."""
    from repro_torch.dist.sharding import local_shape
    shape = (batch, heads, dh)
    shape = (*lead, *(local_shape(shape, SLSTM_STATE_AXES) if local
                      else shape))

    def full(v):
        return torch.full(shape, v, dtype=torch.float32, device=device)
    return (full(0.0), full(1e-6), full(-1e30), full(0.0))


def slstm_cell_scan(gx: torch.Tensor, r: torch.Tensor, state):
    """gx: (B, S, 4, H, dh) input-side gate preactivations (z, i, f, o);
    r: (4, H, dh, dh), the recurrent weights read as ``"ghde,bhe->bghd"``
    (the last axis of r contracts with h).  Returns (h (B, S, H, dh),
    state)."""
    B, S, G, H, dh = gx.shape
    # (H, 4 dh, dh): one batched matmul a step gives every gate's rec
    rr = r.float().permute(1, 0, 2, 3).reshape(H, G * dh, dh)
    c, n, m, h = state
    hs = []
    for t in range(S):
        rec = torch.bmm(rr, h.permute(1, 2, 0))               # (H, 4dh, B)
        g = gx[:, t] + rec.reshape(H, G, dh, B).permute(3, 1, 0, 2)
        zt = torch.tanh(g[:, 0])
        li = g[:, 1]
        lf = F.logsigmoid(g[:, 2])
        ot = torch.sigmoid(g[:, 3])
        m_new = torch.maximum(lf + m, li)
        fp, ip = torch.exp(lf + m - m_new), torch.exp(li - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        h = ot * c / torch.maximum(n, torch.exp(-m_new))
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


def slstm_block_apply(p, x: torch.Tensor, cfg: ModelConfig, state=None,
                      tp=None):
    """x: (B, S, d) -> (y, state); the block's own gated FFN follows the
    cell.

    With ``tp`` (the training forward, no state): wx column-parallel, its
    gate preactivations gathered whole (on 2 ranks rank 0's block holds
    z and i, rank 1's f and o); where ``r`` holds the rank's heads, the
    four gates of those heads are cut out before the step loop, which
    then runs on them with no collective, and its output is gathered
    whole; the norm replicated; ``ff_up`` / ``ff_gate`` column-parallel and
    ``ff_down`` row-parallel where the rank holds a block of the FFN."""
    B, S, d = x.shape
    H = cfg.num_heads
    dh = d // H
    wx_split = tp is not None and p["wx"]["w"].shape[-1] != 4 * d
    heads_split = tp is not None and p["r"].shape[-3] != H
    Hl = H // tp.parts if heads_split else H
    if state is None:
        state = slstm_state_init(B, Hl, dh, device=x.device, local=False)
    gx = layers.linear(p["wx"], tp.copy(x) if wx_split else x,
                       torch.float32)
    if wx_split:
        gx = tp.gather_cat(gx)
    if heads_split:
        gx = tp.split_groups(gx, 4)
    h, state = slstm_cell_scan(gx.reshape(B, S, 4, Hl, dh), p["r"], state)
    h = h.reshape(B, S, Hl * dh)
    if heads_split:
        h = tp.gather_cat(h)
    h = layers.apply_norm(p["norm"], h.to(x.dtype), "rmsnorm")
    cdt = layers.dtype_of(cfg.compute_dtype)
    ff_tp = tp if tp is not None and p["ff_up"]["w"].shape[-1] != int(
        cfg.slstm_proj_factor * d) else None
    if ff_tp is not None:
        h = ff_tp.copy(h)
    y = layers.row_linear(p["ff_down"],
                          layers.linear(p["ff_up"], h, cdt)
                          * F.silu(layers.linear(p["ff_gate"], h, cdt)), cdt,
                          ff_tp)
    return y, state
