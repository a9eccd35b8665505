"""The rule registry: the analysis passes over captured calls (port of
``repro/analysis/rules.py``).

Each rule is a function ``(Trace | domain object, **params) ->
list[Finding]`` registered under a family id.  The families, read for
eager PyTorch (``docs/static_analysis.md`` is the JAX catalog):

``shape``
    No tensor dimension of any op's inputs or outputs may exceed a bound
    (``max_dim`` -- the rank-p solver's no-dimension-beyond-p invariant),
    declared dimensions must be absent (``forbidden_dims`` -- a rank's
    full coordinate widths under a mesh) / present (``require_dims`` --
    detector sanity: at least one of them must show up).
``precision``
    A torch bf16 GEMM accumulates in fp32 inside cuBLAS, so a bf16 output
    of ``mm`` is not JAX's bug class by itself.  The findings are (a) a
    cross-rank sum of a bf16 / fp16 tensor (an ``all_reduce`` that adds);
    (b) ``cumsum``, ``scatter_add``, ``index_add``, ``index_put(...,
    accumulate=True)``, ``addmm`` / ``baddbmm`` / ``addbmm`` / ``addmv``
    (an accumulator input) with a bf16 / fp16 output; (c) a bf16 / fp16
    buffer added into in place more than once in one call; (d) a
    low-precision product on the card while cuBLAS may reduce it in low
    precision (``torch.backends.cuda.matmul.
    allow_bf16_reduced_precision_reduction`` or the fp16 flag; the
    entry points turn the bf16 one off, ``repro_torch.device``).
``transfer``
    No op whose result the host must read (``aten._local_scalar_dense``
    -- ``.item()``, ``bool()``, ``float()`` --, ``_linalg_check_errors``,
    ``nonzero``, ``masked_select``, ``unique*``, ``repeat_interleave``
    with no ``output_size``, ``equal``, ``is_nonzero``), no copy between
    devices (a 0-dim source excepted: JAX's literal ``device_put``), and
    on the card no op in which CUDA's sync-debug mode saw a
    synchronisation (library ops included: ``linalg.eigh`` checks its
    result on the host, which no dispatch-level record shows).
``mask``
    The membership mask must stay on the device: a host read of a tensor
    the mask reaches is a ``python-branch`` finding (membership changes
    would change the captured program); a mask that reaches no output is
    ``<unused>``.
``collectives``
    The bytes a rank hands to its collectives must stay under a budget.

``recompile`` is the sixth family; being a property of several calls it
lives in :mod:`repro_torch.analysis.recompile` (the registry lists it).
The kernel families (``ksites``, ``kbudget``, ``ksentinel``,
``ksanitizer``) live in :mod:`repro_torch.analysis.kernel_rules`.  An op
or collective inside ``analysis.allowed(rule, reason)`` is skipped by
that rule.
"""

from __future__ import annotations

import math

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.trace import (HOST_READ_OPS, LOW_PRECISION, Trace,
                                        capture)

__all__ = ["check_shape", "check_precision", "check_transfer", "check_mask",
           "check_collectives", "full_width_dims", "dispatch_visible",
           "RULES"]


def _need_ops(trace: Trace, rule: str) -> None:
    if trace.ops is None:
        raise ValueError(f"{rule}: the trace {trace.name!r} was never "
                         "captured (analysis.capture)")


# ---------------------------------------------------------------------------
# SHAPE
# ---------------------------------------------------------------------------

def check_shape(trace: Trace, *, max_dim: int | None = None,
                forbidden_dims=(), require_dims=()) -> list[Finding]:
    """SHAPE: bound / forbid / require tensor dimensions over every op's
    inputs and outputs (on a rank of a fake world these are the rank's
    own shapes, which is what makes the no-full-width check mean
    something)."""
    _need_ops(trace, "check_shape")
    forbidden = set(forbidden_dims)
    required = set(require_dims)
    findings: list[Finding] = []
    seen: set[int] = set()
    for op in trace.ops:
        dims = [d for m in op.inputs + op.outputs for d in m.shape]
        seen.update(dims)
        if "shape" in op.allowed:
            continue
        bad = [d for d in dims if (max_dim is not None and d > max_dim)
               or d in forbidden]
        if bad:
            findings.append(Finding(
                "shape", op.name, trace.name, op.evidence(),
                f"tensor dimension(s) {sorted(set(bad))} violate the "
                f"shape contract (max_dim={max_dim}, "
                f"forbidden={sorted(forbidden)})"))
    if required and not (required & seen):
        findings.append(Finding(
            "shape", "<absent>", trace.name,
            f"dims seen: {sorted(seen)[:20]}",
            f"none of the required dimensions {sorted(required)} appear — "
            "the detector is not looking at the graph it thinks it is"))
    return findings


def full_width_dims(tree, n_shards: int) -> tuple[set[int], set[int]]:
    """(forbidden, required) dims for the no-full-width-per-device check
    (a copy of JAX's).

    For a worker-major tree sharded ``n_shards`` ways over the coordinate
    axis: the full flat width of every cleanly-divisible leaf (and its
    leading coordinate dim), plus the concatenated total when every leaf
    divides, must be *absent* from a rank's shapes; at least one per-shard
    width must be *present* (detector sanity).  Leaves whose width does not
    divide ``n_shards`` are excluded -- padding makes their per-rank
    shapes implementation-defined."""
    from repro_torch.launch.dryrun import tensors_of
    leaves = tensors_of(tree)
    forbidden: set[int] = set()
    required: set[int] = set()
    total, all_divide = 0, True
    for leaf in leaves:
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) < 2:
            continue
        flat = math.prod(shape[1:])
        total += flat
        if flat % n_shards == 0 and flat // n_shards > 1:
            forbidden.add(flat)
            required.add(flat // n_shards)
            if shape[1] != flat and shape[1] % n_shards == 0 \
                    and shape[1] // n_shards > 1:
                forbidden.add(shape[1])
                required.add(shape[1] // n_shards)
        else:
            all_divide = False
    if all_divide and total and total % n_shards == 0:
        forbidden.add(total)
    return forbidden - required, required


# ---------------------------------------------------------------------------
# PRECISION
# ---------------------------------------------------------------------------

# out-of-place ops that add into an accumulator (b)
_ACCUM_OUT = frozenset({"cumsum", "scatter_add", "index_add", "addmm",
                        "baddbmm", "addbmm", "addmv", "cumsum_",
                        "scatter_add_", "index_add_", "addmm_",
                        "baddbmm_", "addbmm_", "addmv_"})
_INDEX_PUT = frozenset({"index_put", "index_put_", "_index_put_impl_"})


def _low(dtype) -> bool:
    return dtype in LOW_PRECISION


def check_precision(trace: Trace) -> list[Finding]:
    """PRECISION: low-precision values must be summed in >= fp32 (module
    docstring, cases (a)-(d)).  The fix is an fp32 sum cast once after it:
    an fp32 partial product (``models.layers.product_f32``) or an upcast
    before the collective or the accumulation."""
    _need_ops(trace, "check_precision")
    findings: list[Finding] = []
    for c in trace.collectives:
        if c.sums and _low(c.dtype) and "precision" not in c.allowed:
            findings.append(Finding(
                "precision", c.kind, trace.name, c.evidence(),
                f"{c.collective or 'collective'} {c.kind!r} sums "
                f"{str(c.dtype).removeprefix('torch.')} partials over the "
                "ranks — sum in fp32 and cast once after the sum"))
    for op in trace.ops:
        if "precision" in op.allowed:
            continue
        low_out = bool(op.outputs) and all(_low(m.dtype)
                                           for m in op.outputs)
        if low_out and (op.packet in _ACCUM_OUT or (
                op.packet in _INDEX_PUT and op.accumulate)):
            findings.append(Finding(
                "precision", op.name, trace.name, op.evidence(),
                f"{op.packet} accumulates into a "
                f"{str(op.outputs[0].dtype).removeprefix('torch.')} "
                "result — accumulate in fp32 and cast after"))
        elif op.accum_count == 2:
            findings.append(Finding(
                "precision", op.name, trace.name, op.evidence(),
                "a low-precision buffer is added into in place more than "
                "once — keep the accumulator in fp32"))
        if op.reduced_precision:
            findings.append(Finding(
                "precision", op.name, trace.name, op.evidence(),
                "a low-precision product runs on the card while cuBLAS "
                "may reduce it in low precision (torch.backends.cuda."
                "matmul.allow_bf16_reduced_precision_reduction / the fp16 "
                "flag) — repro_torch.device turns it off"))
    return findings


# ---------------------------------------------------------------------------
# TRANSFER
# ---------------------------------------------------------------------------

_COPIES = frozenset({"_to_copy", "copy_", "to", "_copy_from",
                     "_copy_from_and_resize"})


def _cross_device(op) -> bool:
    if op.packet not in _COPIES or not op.inputs or not op.outputs:
        return False
    devices = {m.device for m in op.inputs + op.outputs} - {"meta"}
    literal = all(len(m.shape) == 0 for m in op.inputs)
    return len(devices) > 1 and not literal


def _host_read(op) -> bool:
    if op.packet in HOST_READ_OPS or op.packet.startswith("unique"):
        return True
    # repeats given as a tensor with no output_size: the host sizes it
    return op.packet == "repeat_interleave" and \
        op.name.split(".")[-1] in ("Tensor", "self_Tensor") and \
        op.output_size is None


def dispatch_visible(op) -> bool:
    """Whether the dispatch-level record alone flags ``op`` (a host read
    or a copy between devices): what a CPU trace of the call sees.  A
    synchronisation the card reports in any other op (a library's own
    check of its result) shows only on the card."""
    return _host_read(op) or _cross_device(op)


def check_transfer(trace: Trace) -> list[Finding]:
    """TRANSFER: no host read, no copy between devices and, on the card,
    no synchronisation in the call (module docstring)."""
    _need_ops(trace, "check_transfer")
    findings: list[Finding] = []
    for op in trace.ops:
        if "transfer" in op.allowed:
            continue
        if _host_read(op):
            findings.append(Finding(
                "transfer", op.name, trace.name, op.evidence(),
                f"{op.packet} reads a device value on the host — the call "
                "waits for the device at this op"))
        elif _cross_device(op):
            findings.append(Finding(
                "transfer", op.name, trace.name, op.evidence(),
                f"{op.packet} copies between devices inside the hot path"))
        elif op.sync:
            findings.append(Finding(
                "transfer", op.name, trace.name, op.evidence(),
                f"the card synchronised inside {op.packet} (CUDA's "
                "sync-debug mode) — no dispatch-level record shows it"))
    for site in trace.syncs_outside:
        findings.append(Finding(
            "transfer", "<sync>", trace.name, site,
            "the card synchronised outside any dispatched op (CUDA's "
            "sync-debug mode), and the call stopped there: a tensor made "
            "from host data, such as torch.tensor(x, device=...)"))
    return findings


# ---------------------------------------------------------------------------
# MASK
# ---------------------------------------------------------------------------

def check_mask(fn, mask, *, name: str = "entry",
               trace: Trace | None = None) -> list[Finding]:
    """MASK: membership-mask discipline for ``fn(mask)``.

    ``fn`` takes the ``(W,)`` mask as its only argument (close over the
    rest), or ``trace`` is a capture of a call with the mask marked
    (``capture(..., taint=mask)``).  Two findings are possible: a host read
    of a value the mask reaches (``python-branch``: a branch on it fixes
    the captured program to this membership), or a mask that reaches no
    output (``<unused>``: the "masked" path silently aggregates absent
    workers).  ``.numpy()`` / ``.tolist()`` of a CPU tensor read its memory
    without dispatching an op, so only the card's run sees those."""
    if trace is None:
        trace = capture(fn, mask, name=name, taint=mask)
    findings = []
    for op in trace.ops:
        if op.tainted and _host_read(op) and "mask" not in op.allowed:
            findings.append(Finding(
                "mask", "python-branch", name, op.evidence(),
                "membership mask is read on the host — it must stay on "
                "the device so membership changes never change the "
                "captured program"))
            break
    if not findings and not trace.outputs_tainted \
            and not trace.syncs_outside:       # a call that ran to its end
        findings.append(Finding(
            "mask", "<unused>", name, f"{len(trace.ops)} op(s) recorded",
            "membership mask is accepted but never consumed — absent "
            "workers would silently participate in the aggregate"))
    return findings


# ---------------------------------------------------------------------------
# COLLECTIVES
# ---------------------------------------------------------------------------

def check_collectives(trace: Trace, *,
                      max_bytes_per_device: float) -> list[Finding]:
    """COLLECTIVES: the bytes this rank hands to its collectives (the
    inputs' bytes, ``dist.sharded.comm_stats``' count; JAX's parser counts
    ring-corrected moved bytes, ~2x an all_reduce's input) must stay under
    ``max_bytes_per_device``.  Needs a trace taken inside a process
    group."""
    if trace.world is None:
        raise ValueError("check_collectives needs a trace taken inside a "
                         "process group (collectives exist only there)")
    total = sum(c.nbytes for c in trace.collectives
                if "collectives" not in c.allowed)
    if total > max_bytes_per_device:
        per_kind: dict = {}
        for c in trace.collectives:
            per_kind[c.kind] = per_kind.get(c.kind, 0) + c.nbytes
        return [Finding(
            "collectives", "total", trace.name,
            f"world={trace.world} per kind: {per_kind}",
            f"per-device collective volume {total:.3e} B exceeds the "
            f"budget {max_bytes_per_device:.3e} B")]
    return []


# ---------------------------------------------------------------------------
# registry (the catalog the CLI and docs enumerate)
# ---------------------------------------------------------------------------

RULES = {
    "shape": check_shape,
    "precision": check_precision,
    "transfer": check_transfer,
    "mask": check_mask,
    "collectives": check_collectives,
    # the family of several calls -- see repro_torch.analysis.recompile
    "recompile": None,
}


def _register_kernel_rules():
    from repro_torch.analysis import kernel_rules as _k
    RULES.update(_k.K_RULES)


_register_kernel_rules()
