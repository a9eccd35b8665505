"""Crash-safe checkpoints of tensor trees (format v2), one file layout with
the JAX package's ``repro.checkpoint``.

Layout: ``<dir>/step_<N>/`` holding, per writing process ``i``:

    state_<i>.npz     one ``.npy`` entry per leaf, keyed by its tree path
                      (bf16 leaves stored as their uint16 bit pattern --
                      numpy has no native bf16)
    meta_<i>.json     step, tree fingerprint, bf16 keys, sorted leaf keys,
                      the caller's ``extra`` metadata (e.g. the LR horizon)
    commit_<i>.json   completeness marker, written *last*: it records the
                      npz byte size

Every file is written to a temporary name in the step dir, flushed and
fsync'd, and renamed into place (``os.replace``), in the order npz ->
meta -> commit.  A crash at any point leaves a step dir without a valid
marker, which :func:`latest_step` and :func:`load_checkpoint` skip; the
marker's byte size also rejects a torn npz.  Dirs of the v1 format (one
shared ``meta.json``, no marker) are still read, complete iff both their
meta and state files exist.

**One layout for both packages.**  A leaf's key is the string
``jax.tree_util.keystr`` gives for the same path (``[i]`` for a sequence
index, ``['k']`` for a dict key, e.g. ``"[0]['body'][0]['ffn']['down']
['w']"``), built here from the paths of :func:`repro_torch.weights.
leaf_items`, whose order is ``jax.tree.leaves``' order.  So ``meta
["keys"]`` is the list the JAX package writes for the same tree, and a
checkpoint written by either package loads into the other bit for bit.
``meta["treedef"]`` is this package's own fingerprint (a hash of the keys
in tree order, prefixed ``repro_torch:``), not JAX's ``str(treedef)``,
which needs JAX to compute; neither package's loader reads it.

**Streaming.**  The npz is written one leaf at a time (``zipfile`` +
``numpy.lib.format.write_array``, as ``np.savez`` writes it, so
``np.load`` reads it as an ordinary npz), and each leaf is copied to the
host only when it is written: host memory peaks at one leaf, never the
whole tree.  A leaf that is a strided view (the rows of one leaf in a
(W, N) buffer) is copied to the host one contiguous slice at a time, so
no device temporary is made either.  :func:`load_checkpoint` fills a
template's tensors **in place** (``copy_``), one leaf at a time, which is
what a train state whose parameters are views of one flat vector needs.

**Leaves held across processes.**  A leaf may be a :class:`DeferredLeaf`
instead of a tensor: the rank's coordinate shard of an EF leaf under
sharded aggregation (``repro_torch.dist.sharded.ShardLeaf``).  Its file
entry is the whole leaf, as a one-process run writes it.  The writing
process gets the array from its ``to_host()``, which gathers it from
every process; the others call :func:`save_checkpoint` with ``write=
False``, which only takes part in those gathers, leaf by leaf in the
same order.  On load each process takes its own part (``load_``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import zipfile

import numpy as np
import torch

from repro_torch.weights import leaf_items

__all__ = ["FORMAT_VERSION", "keystr", "leaf_keys", "save_checkpoint",
           "load_checkpoint", "latest_step", "checkpoint_meta",
           "DeferredLeaf", "copy_leaf"]

FORMAT_VERSION = 2


def keystr(path: tuple) -> str:
    """The key ``jax.tree_util.keystr`` gives for ``path``."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]"
                   for p in path)


def leaf_keys(tree) -> list[str]:
    """The sorted leaf keys of ``tree``: ``meta["keys"]`` of its save."""
    return sorted(keystr(p) for p, _ in leaf_items(tree))


def _fingerprint(keys: list[str]) -> str:
    return "repro_torch:" + hashlib.sha256(
        json.dumps(keys).encode()).hexdigest()[:16]


class DeferredLeaf:
    """A leaf whose values are spread over processes (module docstring):
    ``shape`` and ``dtype`` are the whole leaf's."""

    shape: tuple
    dtype: torch.dtype

    def to_host(self) -> np.ndarray | None:
        """The whole leaf on the writing process, ``None`` on the others;
        every process calls it, in the same order."""
        raise NotImplementedError

    def load_(self, src: torch.Tensor) -> None:
        """Take this process's part of the whole leaf ``src`` (host)."""
        raise NotImplementedError


def copy_leaf(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` across devices, one contiguous slice at a time
    where either side is a strided view (no full-size temporary)."""
    if dst.dim() > 0 and not (dst.is_contiguous() and src.is_contiguous()):
        for i in range(dst.shape[0]):
            copy_leaf(dst[i], src[i])
    else:
        dst.copy_(src)


def _to_host(leaf) -> tuple[np.ndarray, bool]:
    """One leaf on the host as numpy, and whether it is bf16 (returned as
    its uint16 bit pattern)."""
    if isinstance(leaf, DeferredLeaf):
        return leaf.to_host(), False
    t = leaf.detach()
    if t.device.type != "cpu" or not t.is_contiguous():
        host = torch.empty(t.shape, dtype=t.dtype)
        copy_leaf(host, t)
        t = host
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via temp file + fsync + atomic rename."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _state_name(process_index: int) -> str:
    return f"state_{process_index}.npz"


def _meta_name(process_index: int) -> str:
    return f"meta_{process_index}.json"


def _commit_name(process_index: int) -> str:
    return f"commit_{process_index}.json"


def save_checkpoint(directory: str, step: int, tree, *,
                    process_index: int = 0, extra: dict | None = None,
                    write: bool = True) -> str | None:
    """Atomically save ``tree`` (a tree of tensors) as step ``step``.

    Args:
      directory: checkpoint root (created if missing).
      step: global step the state corresponds to.
      tree: nested dicts / lists / tuples of tensors on any device (params,
        optimizer state, EF memory, ...).
      process_index: shard suffix for multi-process writers; state, meta
        and commit marker are all namespaced by it.
      extra: small JSON-able metadata stored in the meta file and returned
        by :func:`checkpoint_meta` (the launchers persist the LR horizon,
        ``total_steps``, here).
      write: ``False`` on a process that does not write: it only takes
        part in the :class:`DeferredLeaf` gathers and returns ``None``.
    Returns:
      The step directory.  The step becomes visible to
      :func:`latest_step` only once its commit marker lands.
    """
    items = [(keystr(p), leaf) for p, leaf in leaf_items(tree)]
    if not write:
        for _, leaf in items:
            if isinstance(leaf, DeferredLeaf):
                leaf.to_host()
        return None
    step_dir = _step_dir(directory, step)
    os.makedirs(step_dir, exist_ok=True)
    fname = os.path.join(step_dir, _state_name(process_index))
    bf16_keys = []
    fd, tmp = tempfile.mkstemp(dir=step_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                                 allowZip64=True) as zf:
                for key, leaf in items:
                    a, is_bf16 = _to_host(leaf)
                    if is_bf16:
                        bf16_keys.append(key)
                    with zf.open(key + ".npy", "w", force_zip64=True) as e:
                        np.lib.format.write_array(e, a, allow_pickle=False)
                    del a
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    keys = [k for k, _ in items]
    meta = {"format": FORMAT_VERSION, "step": step,
            "treedef": _fingerprint(keys), "bf16": bf16_keys,
            "keys": sorted(keys), "extra": dict(extra or {})}
    _atomic_write_bytes(os.path.join(step_dir, _meta_name(process_index)),
                        json.dumps(meta).encode())
    commit = {"step": step, "state_bytes": os.path.getsize(fname)}
    _atomic_write_bytes(os.path.join(step_dir, _commit_name(process_index)),
                        json.dumps(commit).encode())
    return step_dir


def _is_complete(step_dir: str, process_index: int) -> bool:
    """True iff the step dir holds a finished write for ``process_index``."""
    state = os.path.join(step_dir, _state_name(process_index))
    if not os.path.isfile(state):
        return False
    has_meta = (os.path.isfile(os.path.join(step_dir,
                                            _meta_name(process_index)))
                or os.path.isfile(os.path.join(step_dir, "meta.json")))
    if not has_meta:
        return False
    marker = os.path.join(step_dir, _commit_name(process_index))
    if os.path.isfile(marker):
        try:
            with open(marker) as f:
                commit = json.load(f)
            return os.path.getsize(state) == commit["state_bytes"]
        except (ValueError, KeyError, TypeError, OSError):
            return False
    # v1: shared meta.json and no marker -- both files existing is the
    # best completeness signal that format offers
    return os.path.isfile(os.path.join(step_dir, "meta.json"))


def _read_meta(step_dir: str, process_index: int) -> dict:
    path = os.path.join(step_dir, _meta_name(process_index))
    if not os.path.isfile(path):          # v1 layout
        path = os.path.join(step_dir, "meta.json")
    with open(path) as f:
        meta = json.load(f)
    meta.setdefault("format", 1)
    meta.setdefault("extra", {})
    return meta


def checkpoint_meta(directory: str, *, step: int | None = None,
                    process_index: int = 0) -> dict:
    """Meta dict (incl. ``extra``) of a step (default: latest complete)."""
    if step is None:
        step = latest_step(directory, process_index=process_index)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return _read_meta(_step_dir(directory, step), process_index)


def load_checkpoint(directory: str, template, *, step: int | None = None,
                    process_index: int = 0):
    """Restore a step into ``template``'s tensors, in place.

    ``template`` is a tree of tensors with the saved tree's structure;
    each leaf's shape is validated against the stored array, and the
    stored values are copied into it (cast to its dtype), one leaf at a
    time.  ``step=None`` restores the newest *complete* step: partially
    written dirs are skipped.  Returns ``(template, step)``.
    """
    if step is None:
        step = latest_step(directory, process_index=process_index)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    step_dir = _step_dir(directory, step)
    meta = _read_meta(step_dir, process_index)
    bf16 = set(meta["bf16"])
    with np.load(os.path.join(step_dir, _state_name(process_index))) as data:
        for path, leaf in leaf_items(template):
            key = keystr(path)
            a = data[key]
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{a.shape} vs {tuple(leaf.shape)}")
            src = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if key in bf16 else torch.from_numpy(a))
            with torch.no_grad():
                if isinstance(leaf, DeferredLeaf):
                    leaf.load_(src.to(leaf.dtype))
                else:
                    copy_leaf(leaf, src.to(leaf.dtype))
            del a, src
    return template, meta["step"]


def latest_step(directory: str, *, process_index: int = 0,
                process_count: int | None = None) -> int | None:
    """Newest step with a *complete* write for ``process_index`` (or None).

    Incomplete dirs (no commit marker, or an npz whose size disagrees with
    the marker) are skipped.  Multi-process runs pass ``process_count``: a
    step then counts only when complete for every process
    0..process_count-1, so all restarting processes agree on the step.
    """
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    indices = (range(process_count) if process_count is not None
               else (process_index,))
    complete = [s for s in sorted(steps, reverse=True)
                if all(_is_complete(_step_dir(directory, s), i)
                       for i in indices)]
    return complete[0] if complete else None
