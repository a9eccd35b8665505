"""Plain PyTorch versions of the Gram kernels, and the shared chunk plan.

``chunk_schedule`` and ``piece_plan`` are pure-Python copies of the JAX
package's plan (``repro/kernels/gram/ref.py``): the CUDA kernel, the plain
version here and the JAX kernels all visit the identical chunk set, so
``sketch_stride`` keeps the same coordinates everywhere.
"""

from __future__ import annotations

import torch


def chunk_schedule(n: int, block_n: int, stride: int):
    """Static chunk-sampling plan for the one-pass tree Gram.

    The (W, n) worker-major stack is read as ``block_n``-wide chunks;
    ``stride`` > 1 keeps every stride-th chunk and the result is rescaled
    by the exact inverse sampling fraction, so the Gram diagonal stays
    unbiased.  Inputs smaller than one chunk are exact (scale 1).

    Returns:
      (kept, n_pad, scale): number of kept chunks (chunk j starts at column
      ``j * stride * block_n``), the padded width the TPU kernel would use,
      and the fp32 rescale ``n / coords_covered``.
    """
    if n <= 0:
        raise ValueError(f"chunk_schedule: need n > 0, got {n}")
    stride = max(1, stride)
    total = -(-n // block_n)                     # ceil: chunks covering n
    kept = total if stride == 1 else max(1, -(-total // stride))
    # Every kept chunk but the last is full (chunk j + 1 starts at or
    # after the end of chunk j, and the last kept one starts below n), so
    # the JAX package's per-chunk loop has this closed form -- the loop
    # would cost ~0.25 s per call at N = 3.6e8 in an eager step.
    last_off = (kept - 1) * stride * block_n
    covered = (kept - 1) * block_n + min(block_n, n - last_off)
    n_pad = max(-(-n // block_n) * block_n,
                (kept - 1) * stride * block_n + block_n)
    return kept, n_pad, float(n) / float(covered)


def piece_plan(sizes, block_n: int, stride: int):
    """Static (leaf, start, length) pieces covering the kept chunks.

    Maps the kept chunks of the packed (W, n) stream back onto per-leaf
    coordinate ranges, merging contiguous ranges of the same leaf.

    Returns:
      (pieces, scale): pieces is a list of (leaf_index, start, length) over
      flattened per-leaf coordinates; scale as in :func:`chunk_schedule`.
    """
    n = sum(sizes)
    kept, _, scale = chunk_schedule(n, block_n, stride)
    stride = max(1, stride)
    starts = [0]
    for s in sizes:
        starts.append(starts[-1] + s)
    pieces: list[tuple[int, int, int]] = []
    for j in range(kept):
        off = j * stride * block_n
        end = min(off + block_n, n)
        for li in range(len(sizes)):
            a, b = max(off, starts[li]), min(end, starts[li + 1])
            if a >= b:
                continue
            if (pieces and pieces[-1][0] == li
                    and starts[li] + pieces[-1][1] + pieces[-1][2] == a):
                pieces[-1] = (li, pieces[-1][1], pieces[-1][2] + b - a)
            else:
                pieces.append((li, a - starts[li], b - a))
    return pieces, scale


_GROUP = 4096           # chunks per (group, block_n, p) view


def _chunked_gram(G: torch.Tensor, chunks: int, span: int,
                  block_n: int) -> torch.Tensor:
    """sum_c V_c^T V_c, fp32, over the chunks c < ``chunks`` of rows
    [c * span, c * span + block_n) of G (n, p), cut at n: the walk of the
    Gram kernels.  The full chunks are taken a few thousand at a time as
    one (chunks, block_n, p) strided view (no copy) and their Grams summed
    pairwise, the ragged last one on its own, so the rounding error stays
    at the level of the kernel's blocked sums at n ~ 1e8 -- one fp32 GEMM
    over all of n is not that accurate."""
    n, p = G.shape
    sn, sp = G.stride()
    last = (chunks - 1) * span
    full = chunks if last + block_n <= n else chunks - 1
    K = torch.zeros((p, p), dtype=torch.float32, device=G.device)
    for g0 in range(0, full, _GROUP):
        g = min(_GROUP, full - g0)
        V = G.as_strided((g, block_n, p), (span * sn, sn, sp),
                         G.storage_offset() + g0 * span * sn).float()
        K += torch.einsum("kbi,kbj->kij", V, V).sum(dim=0)
    if full < chunks:
        tail = G[last:].float()
        K += tail.T @ tail
    return K


def gram_plain(G: torch.Tensor, block_n: int = 1024) -> torch.Tensor:
    """Plain version of the per-matrix Gram kernel:  K = G^T G, fp32.

    G: (n, p), fp32 or bf16, any strides (a transposed, strided view of the
    (W, N) buffer is read in place), in block_n-row chunks.
    """
    return _chunked_gram(G, -(-G.shape[0] // block_n), block_n, block_n)


def tree_gram_plain(X: torch.Tensor, sketch_stride: int = 1,
                    block_n: int = 1024) -> torch.Tensor:
    """Plain version of the tree-Gram kernel:  K = scale * X_S X_S^T, fp32.

    X: (W, N) worker-major stack (fp32 or bf16, unit column stride), read
    in place as X^T over the kept chunks of :func:`chunk_schedule`.
    """
    stride = max(1, sketch_stride)
    kept, _, scale = chunk_schedule(X.shape[1], block_n, stride)
    K = _chunked_gram(X.T, kept, stride * block_n, block_n)
    return K * scale if scale != 1.0 else K
