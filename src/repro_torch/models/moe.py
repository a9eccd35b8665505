"""Mixture-of-Experts block: top-k softmax routing with capacity dropping
(port of ``repro/models/moe.py``).

The JAX package's semantics, step by step:

  1. **Route** (:func:`route`): router logits in fp32, softmax, the top k
     (expert, prob) per token, the k probs renormalised by
     ``max(sum, 1e-9)``.  ``jax.lax.top_k`` puts the lower expert index
     first among equal probs; ``torch.topk`` promises no order on ties, so
     the top k come from a *stable* descending sort: equal logits pick
     experts 0..k-1 on every device.
  2. **Losses**: ``moe_aux`` (Switch's load balance, from the first
     choice's density only) and ``moe_z`` (the mean squared logsumexp),
     both fp32.
  3. **Capacity** (:func:`capacity_of`): ``int(ceil(T k / E) *
     capacity_factor)`` clamped to ``[8, T]``, in Python integers.
  4. **Plan** (:func:`dispatch_plan`): the T k slots (token-major, slot
     ``t k + j`` is token t's j-th choice) sorted *stably* by expert; a
     slot's position in its expert's segment decides whether it is kept
     (position < capacity), so the same slots are dropped as in JAX.
  5. **Dispatch and combine** as gathers through a partial permutation
     (:class:`_Route`): kept (expert, position) cells and kept slots are
     in one-to-one correspondence, so each direction is a gather through
     one index map and its backward a gather through the inverse map.
     No float scatter-add and no atomics anywhere, forward or backward: a
     token's k expert outputs are gathered back to token-major order,
     weighted by ``keep * p`` in fp32 and summed over k in a fixed order
     (``reshape(T, k, d).sum(1)``), so the result repeats its bits on the
     card, where ``index_add_`` would not.  A dropped slot reads a zero
     row.  The dispatch's source rows are the token rows expanded over k,
     so their gradient is a sum over k, not a scatter into ``xt.grad``.
  6. **Experts**: one batched product per bank over the (E, cap, d)
     buffer (``torch.bmm``: the JAX package's einsums are outside any
     Pallas kernel), compute-dtype operands with fp32 accumulation; the
     shared experts run densely on every token and are summed in fp32.

Under tensor parallelism (:func:`moe_apply`'s ``tp``) the banks split
over ``expert_mlp`` (the default rules) or over ``experts`` (expert
parallelism), as the JAX package's axes and rules say.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

__all__ = ["moe_shapes", "route", "capacity_of", "dispatch_plan",
           "moe_apply"]


def moe_shapes(cfg: ModelConfig, *, lead: tuple = ()) -> dict:
    """``moe_init``'s leaves as shapes with its logical axes: the router
    ``{"w": (d, E)}`` (``("embed", None)``), the routed banks ``w_up`` /
    ``w_gate`` (E, d, d_e) (``("experts", "embed", "expert_mlp")``) and
    ``w_down`` (E, d_e, d) (``("experts", "expert_mlp", "embed")``), and
    ``shared`` with the same banks over ``num_shared`` experts (no
    ``experts`` axis) when there are any; ``lead`` axes go in front."""
    m = cfg.moe
    d = cfg.d_model
    d_e = m.d_expert or cfg.d_ff
    none = (None,) * len(lead)

    def banks(n, experts):
        up = none + (experts, "embed", "expert_mlp")
        return {"w_up": layers.meta(*lead, n, d, d_e, axes=up),
                "w_gate": layers.meta(*lead, n, d, d_e, axes=up),
                "w_down": layers.meta(*lead, n, d_e, d, axes=none + (
                    experts, "expert_mlp", "embed"))}
    p = {"router": layers.linear_shapes(d, m.num_experts, lead=lead,
                                        axes=("embed", None)),
         **banks(m.num_experts, "experts")}
    if m.num_shared:
        p["shared"] = banks(m.num_shared, None)
    return p


def _expert_ffn(w_up, w_gate, w_down, x: torch.Tensor,
                cfg: ModelConfig, *, partial: bool = False) -> torch.Tensor:
    """Batched expert FFN.  x: (E, C, d) with per-expert weight banks.
    ``partial``: the banks hold a block of ``d_e`` and the result is the
    fp32 partial product the caller sums over its group (then casts to
    the compute dtype once, as JAX's partitioned einsum does)."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    act = layers.ACTS[cfg.act]
    up = layers.matmul_c(x, w_up, cdt)
    gate = act(layers.matmul_c(x, w_gate, cdt))
    if partial:
        return layers.product_f32(up * gate, w_down.to(cdt))
    return torch.bmm(up * gate, w_down.to(cdt))


def route(p, xt: torch.Tensor, cfg: ModelConfig):
    """xt: (T, d) -> ``(logits, probs, top_p, top_e)``: fp32 router logits
    and softmax (T, E), the renormalised top-k probs (T, k) and experts
    (T, k), ties to the lower expert index."""
    logits = layers.linear(p["router"], xt, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_p, top_e = vals[:, :k], idx[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_e


def capacity_of(T: int, cfg: ModelConfig, capacity: int | None = None) -> int:
    """Slots an expert keeps for ``T`` tokens (JAX's integer arithmetic)."""
    m = cfg.moe
    cap = capacity or int(-(-T * m.top_k // m.num_experts)
                          * m.capacity_factor)
    return max(8, min(cap, T))


def dispatch_plan(top_e: torch.Tensor, num_experts: int, cap: int):
    """The slot <-> cell maps of one dispatch.  top_e: (T, k).

    Returns ``(dest, cell_src)``: ``dest`` (T k,) the cell ``e * cap +
    position`` of each token-major slot, ``E * cap`` (no cell) where the
    slot is dropped; ``cell_src`` (E cap,) the slot that fills each cell,
    ``T k`` (no slot) where the cell stays empty.  A slot's position is
    its rank within its expert after a stable sort of the slots by expert,
    as in the JAX package."""
    T, k = top_e.shape
    n, E, dev = T * k, num_experts, top_e.device
    flat_e = top_e.reshape(n)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    experts = torch.arange(E, device=dev)
    seg_start = torch.searchsorted(se, experts)
    seg_len = torch.searchsorted(se, experts, right=True) - seg_start
    pos = torch.arange(n, device=dev) - seg_start[se]
    dest_sorted = torch.where(pos < cap, se * cap + pos, E * cap)
    dest = torch.empty_like(dest_sorted)
    dest[order] = dest_sorted                 # a permutation of int indices
    c = torch.arange(cap, device=dev)
    src = order[(seg_start[:, None] + c).clamp(max=n - 1)]
    cell_src = torch.where(c < seg_len[:, None], src, n).reshape(E * cap)
    return dest, cell_src


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``src[idx]``, a zero row where ``idx == len(src)``."""
    n = src.shape[0]
    rows = src.index_select(0, idx.clamp(max=n - 1))
    return torch.where((idx < n)[:, None], rows,
                       torch.zeros((), dtype=src.dtype, device=src.device))


class _Route(torch.autograd.Function):
    """``out = _take(src, fwd)`` through a partial permutation whose
    inverse is ``bwd``: the transpose of the map is the gather through
    ``bwd``, so the backward is ``_take(grad, bwd)`` (no scatter-add)."""

    @staticmethod
    def forward(ctx, src, fwd, bwd):
        ctx.save_for_backward(bwd)
        return _take(src, fwd)

    @staticmethod
    def backward(ctx, grad):
        (bwd,) = ctx.saved_tensors
        return _take(grad, bwd), None, None


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
              capacity: int | None = None, tp=None):
    """x: (B, S, d) -> ``(y, {"moe_aux", "moe_z"})``, y in x's dtype.

    With ``tp`` (the training forward's tensor-parallel group) each bank
    holds the rank's block the rules give it: ``expert_mlp`` split (the
    default rules), a block of ``d_e`` of every expert -- the dispatch
    buffer and the shared experts' input through ``tp.copy``, the expert
    outputs summed over the group before the combine; or ``experts``
    split (expert parallelism), ``E / parts`` whole experts -- the rank
    runs its experts' cells of the buffer and ``tp.gather`` joins the
    experts' outputs before the combine.  The router stays replicated:
    every rank routes the same tokens the same way and builds the same
    dispatch plan, and the combine sees every expert's whole output, so
    the router's gradient is whole on every rank."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    d_e = m.d_expert or cfg.d_ff
    cdt = layers.dtype_of(cfg.compute_dtype)
    xt = x.reshape(T, d)

    logits, probs, top_p, top_e = route(p, xt, cfg)
    # the first choice's one-hot (F.one_hot would check its range on the
    # host: a device sync)
    first = top_e[:, :1] == torch.arange(E, device=x.device)
    density = first.float().mean(0)
    aux = E * torch.sum(density * probs.mean(0)) * m.router_aux_weight
    zloss = torch.mean(torch.logsumexp(logits, -1) ** 2) * m.router_z_weight
    losses = {"moe_aux": aux, "moe_z": zloss}

    cap = capacity_of(T, cfg, capacity)
    dest, cell_src = dispatch_plan(top_e, E, cap)
    # each cell holds at most one token row, so gathering in x's dtype and
    # casting equals JAX's fp32 scatter-add followed by the cast
    xk = xt.unsqueeze(1).expand(T, k, d).reshape(T * k, d)
    buf = _Route.apply(xk, cell_src, dest).reshape(E, cap, d).to(cdt)
    banks = (p["w_up"], p["w_gate"], p["w_down"])
    if tp is not None and p["w_up"].shape[-3] != E:        # experts split
        y_exp = tp.gather(_expert_ffn(*banks, tp.split(buf, dim=0), cfg)
                          ).reshape(E, cap, d)
    elif tp is not None and p["w_up"].shape[-1] != d_e:    # d_e split
        y_exp = tp.reduce(_expert_ffn(*banks, tp.copy(buf), cfg,
                                      partial=True)).to(cdt)
    else:
        y_exp = _expert_ffn(*banks, buf, cfg)

    y_slots = _Route.apply(y_exp.reshape(E * cap, d), dest, cell_src)
    w = (dest < E * cap).float() * top_p.reshape(T * k)
    y = (y_slots.float() * w[:, None]).reshape(T, k, d).sum(1)

    if "shared" in p:
        sh = p["shared"]
        xs = xt.unsqueeze(0).expand(m.num_shared, T, d)
        split = tp is not None and sh["w_up"].shape[-1] != d_e
        y_sh = _expert_ffn(sh["w_up"], sh["w_gate"], sh["w_down"],
                           tp.copy(xs) if split else xs, cfg, partial=split)
        if split:
            y_sh = tp.reduce(y_sh).to(cdt)
        y = y + y_sh.float().sum(0)

    return y.reshape(B, S, d).to(x.dtype), losses
