"""Capture one call for the analysis rules (port of ``capture`` / ``Graph``
/ ``iter_eqns`` in ``repro/analysis/rules.py`` and of
``repro/analysis/hlo.py``).

JAX traces an entry point to a jaxpr and compiles it to HLO, and its rules
walk those.  Eager PyTorch has neither.  :func:`capture` runs the call
once under a ``TorchDispatchMode`` that records, op by op, what the rules
read (:class:`Op`): the aten operator, the shapes, dtypes and devices of
its inputs and outputs, its non-tensor arguments, the ``file:line`` of
the innermost ``src/repro_torch/`` frame that issued it, the
``repro_torch::*`` custom operators (the hand-written kernels' launches),
whether it read a tensor tainted by a marked input (MASK), how often a
low-precision buffer was accumulated into in place (PRECISION), and, on
the card, whether CUDA's sync-debug mode reported a synchronisation
inside it (TRANSFER).  The collectives the call hands to
``repro_torch.dist.sharded._run`` are recorded beside the ops
(:class:`Collective`: kind, collective, reduce op, dtype, bytes).

``fake=True`` runs the call on ``FakeTensorMode`` copies of its tensor
arguments: shapes, dtypes and devices without values or memory, as
``repro_torch.launch.dryrun`` traces the production mesh (its
``tensors_of`` finds the arguments' tensors).  A fake CUDA copy reaches
every kernel through its custom operator's fake implementation, so the
kernel site counts are taken on the CPU.

``repro/analysis/hlo.py`` has no port: HLO text does not exist here.  Its
shape scan is the shapes of the trace's ops, its ``parse_collectives``
is the trace's collective records (the bytes each rank hands to a
collective, as ``dist.sharded.comm_stats`` counts them; JAX's parser
counts ring-corrected moved bytes instead), and its ``parse_cost`` is
``launch.dryrun.trace``'s counts (FLOPs, bytes accessed, peak).

:class:`allowed` names a finding that stays at its site: the port's code
wraps the one op in ``with allowed(rule, reason):``.  With no capture
running it costs one test of a global; inside a capture the ops it covers
are recorded as allowed for ``rule`` (the rules skip them, the report
counts them), and on the card it lets a synchronisation through (CUDA's
sync-debug mode off inside it) and counts it; an op in it that
synchronises is still marked, as allowed.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field, fields, is_dataclass, replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["Meta", "Op", "Collective", "Trace", "capture", "allowed",
           "LOW_PRECISION", "HOST_READ_OPS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frames a record's stack passes over: this package and the generic
# collective helpers (a collective's site is the layer that asked for it)
_SKIP = (os.path.join(_PKG, "analysis") + os.sep,
         os.path.join(_PKG, "dist", "sharded.py"),
         os.path.join(_PKG, "dist", "tensor_parallel.py"))
LOW_PRECISION = (torch.bfloat16, torch.float16)
# ops whose result the host must read before the call can go on
HOST_READ_OPS = frozenset({
    "_local_scalar_dense", "_linalg_check_errors", "nonzero",
    "masked_select", "unique", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "equal", "is_nonzero"})
# in-place ops that add into their destination
ACCUM_INPLACE = frozenset({
    "add_", "sub_", "addmm_", "baddbmm_", "addbmm_", "addmv_", "index_add_",
    "scatter_add_", "addcmul_", "addcdiv_", "cumsum_", "index_put_",
    "_index_put_impl_"})
_SYNC_MSG = "synchronizing CUDA operation"


# ---------------------------------------------------------------------------
# allowed sites
# ---------------------------------------------------------------------------

class _Checks:
    active = 0              # captures running: `allowed` is inert at 0
    scopes: list = []       # the open `allowed` scopes, innermost last
    hits: dict = {}         # (rule, reason, site) -> times entered
    sync_debug = False      # a capture runs CUDA's sync-debug mode


class allowed:
    """``with allowed(rule, reason):`` -- the op inside stays, for
    ``rule``, on purpose (module docstring)."""

    __slots__ = ("rule", "reason", "_on", "_prev")

    def __init__(self, rule: str, reason: str):
        self.rule, self.reason = rule, reason

    def __enter__(self):
        self._on = _Checks.active > 0
        if self._on:
            site = _site_of(sys._getframe(1))
            key = (self.rule, self.reason, site)
            _Checks.hits[key] = _Checks.hits.get(key, 0) + 1
            _Checks.scopes.append(self.rule)
            if _Checks.sync_debug:
                self._prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode(0)
        return self

    def __exit__(self, *exc):
        if self._on:
            _Checks.scopes.pop()
            if _Checks.sync_debug:
                torch.cuda.set_sync_debug_mode(self._prev)
        return False


def _site_of(frame, lineno: int | None = None) -> str:
    """``file:line`` (relative to ``src/``) of ``frame``."""
    path = frame.f_code.co_filename
    rel = os.path.relpath(path, os.path.dirname(_PKG)) \
        if path.startswith(_PKG) else os.path.basename(path)
    return f"{rel}:{lineno or frame.f_lineno}"


def _stack(limit: int = 4) -> tuple[str, ...]:
    """The innermost ``limit`` frames of ``src/repro_torch/`` (outside
    this package and the collective helpers), innermost first."""
    out = []
    frame = sys._getframe(1)
    while frame is not None and len(out) < limit:
        path = frame.f_code.co_filename
        if path.startswith(_PKG) and not path.startswith(_SKIP):
            out.append(_site_of(frame))
        frame = frame.f_back
    return tuple(out)


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Meta:
    shape: tuple[int, ...]
    dtype: torch.dtype
    device: str

    @staticmethod
    def of(t: torch.Tensor) -> "Meta":
        return Meta(tuple(int(d) for d in t.shape), t.dtype, t.device.type)

    def __str__(self) -> str:
        return (f"{str(self.dtype).removeprefix('torch.')}"
                f"[{','.join(map(str, self.shape))}]@{self.device}")


@dataclass
class Op:
    """One dispatched operator of a captured call."""

    name: str                         # e.g. "aten.mm.default"
    inputs: tuple[Meta, ...]
    outputs: tuple[Meta, ...]
    scalars: tuple                    # non-tensor arguments, repr'd
    stack: tuple[str, ...]            # issuing frames, innermost first
    allowed: frozenset = frozenset()  # rules an `allowed` scope names
    tainted: bool = False             # read a tensor the mask reaches
    accumulate: bool = False          # index_put(..., accumulate=True)
    accum_count: int = 0              # in-place adds into a low buffer
    reduced_precision: bool = False   # cuBLAS's reduced bf16/fp16 sums
    sync: bool = False                # the card synchronised inside it
    output_size: int | None = None    # the op's output_size= argument

    @property
    def packet(self) -> str:
        """The operator's name without namespace and overload."""
        return self.name.split(".")[1] if "." in self.name else self.name

    @property
    def namespace(self) -> str:
        return self.name.split(".")[0]

    @property
    def site(self) -> str:
        return self.stack[0] if self.stack else "<torch>"

    def evidence(self) -> str:
        ins = ", ".join(map(str, self.inputs))
        outs = ", ".join(map(str, self.outputs))
        sc = f" {list(self.scalars)}" if self.scalars else ""
        return (f"{' < '.join(self.stack) or '<torch>'}: {self.name}"
                f"({ins}){sc} -> ({outs})")

    def signature(self) -> tuple:
        """What a captured graph of this op fixes: the op, its shapes
        and dtypes, and (unless an ``allowed("recompile", ...)`` scope
        covers it) its non-tensor arguments."""
        sc = () if "recompile" in self.allowed else self.scalars
        return (self.name, self.inputs, self.outputs, sc)


@dataclass
class Collective:
    """One collective handed to ``dist.sharded._run``."""

    kind: str
    collective: str                   # all_reduce / all_gather / ...
    op: str | None                    # the reduce op, lower case
    dtype: torch.dtype
    nbytes: int
    stack: tuple[str, ...]
    allowed: frozenset = frozenset()

    @property
    def site(self) -> str:
        return self.stack[0] if self.stack else "<torch>"

    @property
    def sums(self) -> bool:
        """A cross-rank sum: an all_reduce whose op adds."""
        reduce = "reduce" in (self.collective or self.kind)
        return reduce and (self.op is None
                           or self.op in ("sum", "avg", "premul_sum"))

    def evidence(self) -> str:
        return (f"{' < '.join(self.stack) or '<torch>'}: {self.collective or '?'}"
                f"[{self.op or '-'}] kind={self.kind} "
                f"{str(self.dtype).removeprefix('torch.')} {self.nbytes} B")


@dataclass
class Trace:
    """One captured call, ready for the rules; ``ops`` is ``None`` for a
    trace that was never captured."""

    name: str
    ops: list[Op] | None = None
    collectives: list[Collective] = field(default_factory=list)
    world: int | None = None          # process-group size; None: no group
    device: str = "cpu"
    fake: bool = False
    outputs_tainted: bool | None = None
    # file:line of a synchronisation the card reported outside any
    # recorded op (a tensor made from host data copies before dispatch):
    # the call stopped there
    syncs_outside: list = field(default_factory=list)
    allowed: dict = field(default_factory=dict)
    output: object = None

    def sites(self, namespace: str = "repro_torch") -> list[Op]:
        """The custom-operator launches of ``namespace``."""
        return [op for op in self.ops or () if op.namespace == namespace]

    def signature(self) -> tuple:
        return tuple(op.signature() for op in self.ops or ())


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except Exception:           # a tensor without storage (nested, ...)
        return None


def _written(func, args, kwargs) -> list[torch.Tensor]:
    """The tensor arguments ``func`` writes in place."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out += [t for t in tree_flatten(v)[0] if isinstance(t, torch.Tensor)]
    return out


def _scalar(v):
    if isinstance(v, (torch.dtype, torch.device, torch.layout,
                      torch.memory_format)):
        return str(v)
    if isinstance(v, float) and v != v:
        return "nan"                    # so that signatures compare equal
    if isinstance(v, (int, float, bool, str, type(None))):
        return v
    return type(v).__name__


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: Trace, sync_debug: bool):
        super().__init__()
        self.trace = trace
        self.sync_debug = sync_debug
        self.tainted: set = set()           # storage keys the mask reaches
        self.accum: dict = {}               # storage key -> in-place adds

    def is_tainted(self, t: torch.Tensor) -> bool:
        return getattr(t, "_analysis_taint", None) == id(self) or \
            _storage_key(t) in self.tainted

    def taint(self, t: torch.Tensor) -> None:
        try:
            t._analysis_taint = id(self)
        except Exception:
            pass
        key = _storage_key(t)
        if key is not None:
            self.tainted.add(key)

    def _call(self, func, args, kwargs):
        if not self.sync_debug:
            return func(*args, **kwargs), False
        # "error" around every op, inside an allowed scope too (which
        # turns the mode off for what runs outside any op): the op that
        # synchronised is recorded and run again with the mode off
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            try:
                return func(*args, **kwargs), False
            except RuntimeError as e:
                # a copy runs again to the same result; any other op that
                # writes in place might not
                if _SYNC_MSG not in str(e) or (func._schema.is_mutable and
                                               "copy" not in str(func)):
                    raise
            torch.cuda.set_sync_debug_mode(0)
            return func(*args, **kwargs), True
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        tin = [t for t in flat if isinstance(t, torch.Tensor)]
        tainted = any(self.is_tainted(t) for t in tin)
        out, sync = self._call(func, args, kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        written = _written(func, args, kwargs)
        fresh = not func.is_view and not written
        if fresh:                       # new storages: forget their past
            for t in outs:
                key = _storage_key(t)
                self.tainted.discard(key)
                self.accum.pop(key, None)
        if tainted:
            for t in outs + written:
                self.taint(t)
        name = str(func)
        packet = name.split(".")[1] if "." in name else name
        accumulate = bool(kwargs.get("accumulate", False)) or (
            packet in ("index_put", "index_put_", "_index_put_impl_")
            and len(args) > 3 and bool(args[3]))
        accum_count = 0
        if packet in ACCUM_INPLACE and (packet not in (
                "index_put_", "_index_put_impl_") or accumulate):
            for t in written:
                if t.dtype in LOW_PRECISION:
                    key = _storage_key(t)
                    self.accum[key] = self.accum.get(key, 0) + 1
                    accum_count = max(accum_count, self.accum[key])
        low_dot = any(t.dtype in LOW_PRECISION for t in tin) and \
            any(t.device.type == "cuda" for t in tin)
        reduced = low_dot and packet in ("mm", "bmm", "addmm", "baddbmm",
                                         "addbmm", "addmv", "mv", "dot") \
            and any(
                (t.dtype == torch.bfloat16 and torch.backends.cuda.matmul.
                 allow_bf16_reduced_precision_reduction) or
                (t.dtype == torch.float16 and torch.backends.cuda.matmul.
                 allow_fp16_reduced_precision_reduction) for t in tin)
        self.trace.ops.append(Op(
            name=name,
            inputs=tuple(Meta.of(t) for t in tin),
            outputs=tuple(Meta.of(t) for t in outs),
            scalars=tuple(_scalar(v) for v in flat
                          if not isinstance(v, torch.Tensor)),
            stack=_stack(), allowed=frozenset(_Checks.scopes),
            tainted=tainted, accumulate=accumulate,
            accum_count=accum_count, reduced_precision=reduced, sync=sync,
            output_size=kwargs.get("output_size")))
        return out

    def collective(self, kind, nbytes, ref, collective, op) -> None:
        self.trace.collectives.append(Collective(
            kind=kind, collective=collective,
            op=None if op is None else getattr(op, "name", str(op)).lower(),
            dtype=ref.dtype, nbytes=nbytes, stack=_stack(),
            allowed=frozenset(_Checks.scopes)))


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

def _map_tensors(obj, f):
    """``obj`` with every tensor in its dicts, lists, tuples and
    dataclasses replaced by ``f(tensor)``."""
    if isinstance(obj, torch.Tensor):
        return f(obj)
    if isinstance(obj, dict):
        return type(obj)((k, _map_tensors(v, f)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_map_tensors(v, f) for v in obj)
    if is_dataclass(obj) and not isinstance(obj, type):
        kw = {fl.name: _map_tensors(getattr(obj, fl.name), f)
              for fl in fields(obj) if fl.init}
        return replace(obj, **kw)
    return obj


def _world() -> int | None:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else None


def capture(fn, *args, name: str | None = None, fake: bool = False,
            fake_device: str | None = None, taint=None,
            sync_debug: bool | None = None, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` once and record it (module docstring).

    Args:
      fake: run on ``FakeTensorMode`` copies of the tensor arguments (on
        ``fake_device`` where given, else each tensor's own device); the
        real arguments are neither read nor written.
      taint: a tensor argument (by identity) whose reach the trace
        follows: ``Op.tainted`` and ``Trace.outputs_tainted`` (MASK).
      sync_debug: run under CUDA's sync-debug mode (``"error"``) and record
        where the card synchronised: an op that raised is marked
        (``Op.sync``) and run again with the mode off, so the call goes on
        and every such op is listed; a sync before any op dispatched (a
        tensor made from host data) stops the call, its site in
        ``Trace.syncs_outside``; default: where a tensor argument is a
        real CUDA tensor.
    Returns the :class:`Trace`; ``Trace.output`` holds the call's result.
    """
    from repro_torch.dist import sharded
    from repro_torch.launch.dryrun import tensors_of
    name = name or getattr(fn, "__qualname__", getattr(fn, "__name__",
                                                       "entry"))
    real = tensors_of(args, kwargs)
    if sync_debug is None:
        sync_debug = not fake and any(t.is_cuda for t in real)
    trace = Trace(name, ops=[], world=_world(), fake=fake,
                  device=(fake_device or next(
                      (t.device.type for t in real), "cpu")))
    rec = _Recorder(trace, sync_debug)

    def run(a, kw):
        if taint is not None:
            marked = [t for t in tensors_of(a, kw)
                      if getattr(t, "_analysis_mark", False)]
            for t in marked:
                rec.taint(t)
        with rec:
            out = fn(*a, **kw)
        trace.outputs_tainted = any(
            rec.is_tainted(t) for t in tensors_of(out))
        return out

    if taint is not None:
        taint._analysis_mark = True
    prev_hits, _Checks.hits = _Checks.hits, {}
    prev_sync = _Checks.sync_debug
    _Checks.active += 1
    _Checks.sync_debug = sync_debug
    sharded._OBSERVERS.append(rec.collective)
    mode = None
    try:
        if sync_debug:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        if fake:
            from torch._subclasses.fake_tensor import FakeTensorMode
            with FakeTensorMode(allow_non_fake_inputs=False) as fm:
                def fk(t):
                    if fake_device is None:
                        c = fm.from_tensor(t)
                    else:
                        c = torch.empty_strided(
                            t.shape, t.stride(), dtype=t.dtype,
                            device=fake_device,
                            requires_grad=t.requires_grad)
                    if getattr(t, "_analysis_mark", False):
                        c._analysis_mark = True
                    return c
                a, kw = _map_tensors((args, kwargs), fk)
                trace.output = run(a, kw)
        else:
            trace.output = run(args, kwargs)
    except RuntimeError as e:
        if not (sync_debug and _SYNC_MSG in str(e)):
            raise
        trace.syncs_outside.append(_raise_site(e))
    finally:
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        sharded._OBSERVERS.remove(rec.collective)
        _Checks.active -= 1
        _Checks.sync_debug = prev_sync
        trace.allowed = _Checks.hits
        for k, v in _Checks.hits.items():
            prev_hits[k] = prev_hits.get(k, 0) + v
        _Checks.hits = prev_hits
        if taint is not None:
            del taint._analysis_mark
    return trace


def _raise_site(e: BaseException) -> str:
    """``file:line`` of the innermost frame of the port (outside this
    package) that ``e`` passed through."""
    site, tb = "<torch>", e.__traceback__
    while tb is not None:
        path = tb.tb_frame.f_code.co_filename
        if path.startswith(_PKG) and not path.startswith(_SKIP):
            site = _site_of(tb.tb_frame, tb.tb_lineno)
        tb = tb.tb_next
    return site
