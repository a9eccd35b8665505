"""The ``@contract`` decorator: declared invariants on entry points (port of
``repro/analysis/contract.py``).

Usage (the live sites are ``repro_torch.dist.aggregation`` and
``repro_torch.core.gram``)::

    @contract(fp32_contractions=True, no_full_width=True, mask_traced=True)
    def aggregate_tree(X, cfg, *, gram=None, mask=None, sharded=None, ...):
        ...

    @contract(max_dim=lambda K, *a, **k: K.shape[0])
    def fa_weights_from_gram(K, cfg, *, solver="rank_p", mask=None):
        ...

Semantics:

* **zero-cost when disabled** (the default): the wrapper is one global
  boolean test and a tail call.  Enable with ``REPRO_CONTRACTS=1`` in the
  environment, :func:`enable_contracts`, or the :func:`checking` context
  manager.
* **checked once per signature**: the first call with a given signature
  (shapes, dtypes and devices of the tensors, the other arguments' values)
  runs the declared rules; violations raise
  :class:`repro_torch.analysis.findings.ContractViolation`.  Later calls
  with the same signature run bare.
* **checked on the call itself**: JAX traces without running; eager torch
  runs to trace.  A second run would apply an in-place update twice (the
  error-feedback memory ``compressed_aggregate`` writes, the optimizer
  state), and a copy of the arguments would double a full-width stack on
  the card (X is 21.7 GB at W = 15, N = 361,821,120).  So the checked call
  is the caller's own call, recorded once
  (:func:`repro_torch.analysis.trace.capture`, the mask marked): every
  rule below reads that one record and the result is returned as the
  bare call would return it.  Under a mesh that record is this rank's:
  its shapes are the rank's own, which is what the no-full-width check
  reads.
* **capture-transparent**: a contracted call made while a capture runs
  (inside a checked call, a ``capture`` or a lint entry) runs bare: the
  enclosing record already holds its ops, as JAX's contract passes
  tracers through to the enclosing jit.

Declared invariants:

* ``max_dim`` -- SHAPE: no dimension of any op's inputs or outputs
  exceeds the bound; an int, or a callable of the call's ``(*args,
  **kwargs)`` that may return ``None`` to waive it (the q-space oracle).
* ``no_full_width`` -- SHAPE, active only when the call carries
  ``sharded=``: no op of this rank may carry a full coordinate width of
  the stack (each leaf's size of ``leaf_sizes=`` and their total,
  :func:`repro_torch.analysis.rules.full_width_dims`), and the rank's
  shard width must appear.
* ``fp32_contractions`` -- PRECISION.
* ``no_host_transfers`` -- TRANSFER (on the card also CUDA's sync-debug
  mode over the call).
* ``mask_traced`` -- MASK, active only when the call carries a non-None
  ``mask=``.
* ``kernel_race`` -- recorded in ``__contract__`` only: its twin is the
  card's ``compute-sanitizer`` run (``chip_smoke.py``'s ``analysis``
  phase, :func:`repro_torch.analysis.kernel_rules.check_sanitizer`).
* ``kernel_budget`` -- KBUDGET over the built libraries of the kernels
  the call launched (``repro_torch::*`` sites); nothing is built on a
  machine without the card, where it holds vacuously.
"""

from __future__ import annotations

import functools
import os
from contextlib import contextmanager

import torch

from repro_torch.analysis.findings import ContractViolation, Finding
from repro_torch.analysis.kernel_rules import SMEM_LIMIT_BYTES
from repro_torch.analysis.rules import (check_mask, check_precision,
                                        check_shape, check_transfer)
from repro_torch.analysis.trace import _Checks, capture

__all__ = ["contract", "contracts_enabled", "enable_contracts", "checking"]

# custom operator -> the CUDA source its kernel is built from
_SOURCE_OF = {"tree_gram": "gram", "gram": "gram",
              "weighted_sum": "weighted_sum", "coord_stats": "coord_stats",
              "krum_scores": "krum_select", "bulyan_select": "krum_select",
              "flash_attn": "flash_attn"}


class _State:
    enabled = os.environ.get("REPRO_CONTRACTS", "").lower() in (
        "1", "true", "on", "yes")


def contracts_enabled() -> bool:
    return _State.enabled


def enable_contracts(on: bool = True) -> bool:
    """Turn contract checking on/off; returns the previous setting."""
    prev, _State.enabled = _State.enabled, bool(on)
    return prev


@contextmanager
def checking(on: bool = True):
    """Scoped :func:`enable_contracts` (the test-suite idiom)."""
    prev = enable_contracts(on)
    try:
        yield
    finally:
        enable_contracts(prev)


def _sig_key(args, kwargs):
    def one(x):
        if isinstance(x, torch.Tensor):
            return ("tensor", tuple(x.shape), str(x.dtype), x.device.type)
        if isinstance(x, dict):
            return ("dict", tuple((k, one(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(one(v) for v in x))
        try:
            return repr(x)
        except Exception:
            return type(x).__name__
    return (one(args), one(kwargs))


def _check_full_width(trace, args, kwargs) -> list[Finding]:
    """SHAPE no-full-width of a sharded call's record."""
    from repro_torch.analysis.rules import full_width_dims
    from repro_torch.dist.sharded import coord_shards, n_coord_shards
    from repro_torch.dist.sharding import current_mesh
    from repro_torch.launch.mesh import Mesh
    sharded, sizes = kwargs.get("sharded"), kwargs.get("leaf_sizes")
    if not sharded or sizes is None:
        return []
    mesh = sharded if isinstance(sharded, Mesh) else current_mesh()
    if mesh is None:
        return []
    shards = n_coord_shards(mesh)
    W = args[0].shape[0]
    tree = [torch.empty((W, n), device="meta") for n in sizes]
    forbidden, required = full_width_dims(tree, shards)
    required = set(required) | {coord_shards(sizes, mesh).width}
    if not forbidden:
        return []
    return check_shape(trace, forbidden_dims=forbidden,
                       require_dims=required)


def _check_budget(trace, name, budget) -> list[Finding]:
    from repro_torch.analysis.kernel_rules import (check_kernel_budget,
                                                   parse_ptxas)
    from repro_torch.kernels import _build
    sources = sorted({_SOURCE_OF.get(op.packet, op.packet)
                      for op in trace.sites()
                      if any(m.device == "cuda" for m in op.inputs)})
    if not sources:
        return []
    built = _build.build_all(sources)
    lines = [ln for b in built.values() for ln in b.ptxas]
    return check_kernel_budget(parse_ptxas(lines), name=name,
                               max_smem=budget)


def contract(*, max_dim=None, no_full_width: bool = False,
             fp32_contractions: bool = False,
             no_host_transfers: bool = False, mask_traced: bool = False,
             kernel_race: bool = False, kernel_budget=None):
    """Declare invariants on an entry point (see module docstring)."""

    def deco(fn):
        name = getattr(fn, "__qualname__", getattr(fn, "__name__", "entry"))
        checked: set = set()

        def checked_call(args, kwargs):
            mask = kwargs.get("mask") if mask_traced else None
            trace = capture(fn, *args, name=name, taint=mask,
                            sync_debug=None if no_host_transfers
                            else False, **kwargs)
            findings: list[Finding] = []
            if max_dim is not None:
                bound = (max_dim(*args, **kwargs) if callable(max_dim)
                         else int(max_dim))
                if bound is not None:      # a callable may waive it
                    findings += check_shape(trace, max_dim=int(bound))
            if fp32_contractions:
                findings += check_precision(trace)
            if no_host_transfers:
                findings += check_transfer(trace)
            if mask is not None:
                findings += check_mask(None, mask, name=name, trace=trace)
            if kernel_budget is not None and kernel_budget is not False:
                findings += _check_budget(
                    trace, name, SMEM_LIMIT_BYTES if kernel_budget is True
                    else int(kernel_budget))
            if no_full_width:
                findings += _check_full_width(trace, args, kwargs)
            if findings:
                raise ContractViolation(findings, name=name)
            return trace.output

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # bare while a capture runs: the enclosing record holds the ops
            if not _State.enabled or _Checks.active:
                return fn(*args, **kwargs)
            key = _sig_key(args, kwargs)
            if key in checked:
                return fn(*args, **kwargs)
            out = checked_call(args, kwargs)
            checked.add(key)
            return out

        wrapper.__contract__ = {
            "max_dim": max_dim, "no_full_width": no_full_width,
            "fp32_contractions": fp32_contractions,
            "no_host_transfers": no_host_transfers,
            "mask_traced": mask_traced, "kernel_race": kernel_race,
            "kernel_budget": kernel_budget}
        wrapper.__wrapped__ = fn
        return wrapper

    return deco
