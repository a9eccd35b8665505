"""Gram-space Flag Aggregator: FA weights c from the (p, p) Gram K alone.

Port of ``repro/core/gram.py`` (its module docstring holds the
derivations), with both solvers:

``rank_p`` (the default and the train step's)
    Every IRLS iteration works on p x p matrices: factor
    Kt + delta I = L L^T, form the pencil L^T H(u) L with H(u) the data
    weights plus the pairwise Laplacian, take its top-m eigenvectors Q_m,
    and read explained variances and the combine weights

        c~ = (1/W_a) L^{-T} Q_m Q_m^T L^{-1} Kt nu',   c = c~ / nu

    through triangular solves.

``qspace`` (the cross-check oracle)
    builds the (p, q) mixing matrix A of the q = p + p(p-1)/2 data and
    pairwise columns and the (q, q) column Gram S = A^T Kt A, and takes a
    q x q ``eigh`` per IRLS iteration: O(p^6) time, O(p^4) memory.

All of it stays on K's device through ``torch.linalg``: dense linear
algebra that the JAX package also leaves to the library.

The JAX loops leave early once the chordal distance between successive
subspaces drops below ``tol``.  Here each loop always runs ``n_iter`` steps
and freezes its state once converged, which gives the same subspace and
the same ``iterations`` without reading anything back to the host.
Eigenvectors may come back with other signs or order than LAPACK's; they
enter c only through Q_m Q_m^T.
"""

from __future__ import annotations

from functools import partial

import torch

from repro_torch.core import beta_mle
from repro_torch.core.flag import (FlagConfig, default_m, effective_norms,
                                   nan_on_nonfinite)

__all__ = ["fa_weights_from_gram", "flag_aggregate_gram", "gram_matrix"]

SOLVERS = ("rank_p", "qspace")


def gram_matrix(G: torch.Tensor) -> torch.Tensor:
    """K = G^T G in fp32 for a column-major (n, p) G (one GEMM; the tree
    path forms K with the tree-Gram kernel instead)."""
    Gf = G.float()
    return Gf.T @ Gf


def _normalized_gram(K: torch.Tensor, eps: float,
                     mask: torch.Tensor | None = None):
    """(Kt, nu): unit-diagonal normalized Gram and worker norms; with
    ``mask`` inactive workers become phantom unit columns orthogonal to
    everything (zeroed rows/cols, unit diagonal)."""
    p = K.shape[0]
    nu = torch.sqrt(torch.clamp(torch.diagonal(K), min=eps))
    Kt = K / (nu[:, None] * nu[None, :])
    if mask is not None:
        Kt = Kt * (mask[:, None] * mask[None, :])
    eye = torch.eye(p, dtype=K.dtype, device=K.device)
    Kt = Kt - torch.diag(torch.diagonal(Kt)) + eye
    return Kt, nu


def _has_pairs(cfg: FlagConfig, p: int) -> bool:
    return cfg.regularizer == "pairwise" and cfg.lam > 0.0 and p > 1


def _active_count(mask: torch.Tensor | None, p: int, device) -> torch.Tensor:
    """Active-worker count as a device float; the static p when unmasked."""
    if mask is None:
        return torch.tensor(float(p), dtype=torch.float32, device=device)
    return torch.clamp(mask.sum(), min=1.0)


def _mixing(K: torch.Tensor, cfg: FlagConfig, eps: float,
            mask: torch.Tensor | None = None):
    """Normalized Gram Kt, worker norms nu, mixing matrix A (p, q) and the
    per-column objective coefficients; with ``mask`` the data columns of
    inactive workers and every pair touching one get coefficient 0."""
    p = K.shape[0]
    dev, dt = K.device, K.dtype
    Kt, nu = _normalized_gram(K, eps, mask)
    eye = torch.eye(p, dtype=dt, device=dev)
    wa = _active_count(mask, p, dev)
    data_coef = (torch.ones(p, dtype=dt, device=dev) if mask is None
                 else mask.to(dt))
    if _has_pairs(cfg, p):
        ii, jj = torch.triu_indices(p, p, offset=1, device=dev)
        d2 = torch.clamp(2.0 - 2.0 * Kt[ii, jj], min=0.0)
        inv_d = torch.where(d2 > 1e-12,
                            torch.rsqrt(torch.clamp(d2, min=1e-12)),
                            torch.zeros_like(d2))
        A = torch.cat([eye, (eye[:, ii] - eye[:, jj]) * inv_d[None, :]],
                      dim=1)
        pair_coef = cfg.lam / torch.clamp(wa - 1.0, min=1.0)
        pair_valid = (torch.ones(ii.shape[0], dtype=dt, device=dev)
                      if mask is None else mask[ii] * mask[jj])
        coef = torch.cat([data_coef, pair_coef * pair_valid])
    else:
        A, coef = eye, data_coef
    return Kt, nu, A, coef


def _safe_inv(lam: torch.Tensor, eps: float) -> torch.Tensor:
    """Pseudo-inverse of eigenvalues (rank-deficient Grams are expected)."""
    return torch.where(lam > eps, 1.0 / torch.clamp(lam, min=eps),
                       torch.zeros_like(lam))


def _fa_weights_qspace(K: torch.Tensor, cfg: FlagConfig,
                       mask: torch.Tensor | None = None):
    p = K.shape[0]
    m = cfg.m if cfg.m is not None else default_m(p)
    eps = cfg.eps
    Kt, nu, A, coef = _mixing(K, cfg, eps, mask)
    S = A.T @ Kt @ A                        # (q, q), Gram of unit columns
    kw = dict(alpha=cfg.alpha, beta=cfg.beta, a=cfg.a, eps=eps)

    def eig_top_m(u):
        su = torch.sqrt(u)
        lam, V = nan_on_nonfinite(torch.linalg.eigh,
                                  S * (su[:, None] * su[None, :]))
        return lam[-m:], V[:, -m:], su      # ascending: the top m last

    def scaled(lam_m, Vm):
        return Vm * torch.sqrt(_safe_inv(lam_m, eps))[None, :]

    def explained(lam_m, Vm, su):
        # v_c = || L^{-1/2} Vm^T diag(su) S[:, c] ||^2
        Z = scaled(lam_m, Vm).T @ (su[:, None] * S)
        return torch.clamp((Z * Z).sum(dim=0), 0.0, 1.0)

    lam_m, Vm, su = eig_top_m(coef)
    it = torch.zeros((), dtype=torch.int32, device=K.device)
    done = torch.zeros((), dtype=torch.bool, device=K.device)
    for _ in range(cfg.n_iter):
        u_n = beta_mle.irls_weights(explained(lam_m, Vm, su), coef, **kw)
        lam_n, Vn, su_n = eig_top_m(u_n)
        # chordal distance in Gram space:
        #   Y^T Y' = L^{-1/2} V^T diag(su) S diag(su') V' L'^{-1/2}
        C = scaled(lam_m, Vm).T @ (su[:, None] * S * su_n[None, :]) \
            @ scaled(lam_n, Vn)
        c2 = 2.0 * (m - (C * C).sum())
        lam_m, Vm, su = (torch.where(done, a, b) for a, b in
                         ((lam_m, lam_n), (Vm, Vn), (su, su_n)))
        it = it + (~done).to(torch.int32)
        done = done | (c2 < cfg.tol)

    # W = A diag(su) Vm L^{-1} Vm^T diag(su) A^T Kt
    B = A * su[None, :]
    P = (Vm * _safe_inv(lam_m, eps)[None, :]) @ Vm.T
    Wm = B @ P @ (B.T @ Kt)
    nu_eff = effective_norms(nu, cfg.norm_mode, mask)
    c = (Wm @ nu_eff) / (nu * _active_count(mask, p, K.device))
    if mask is not None:
        c = c * mask
    if cfg.renormalize:
        c = c / torch.clamp(c.sum().abs(), min=1e-6)

    v = explained(lam_m, Vm, su)
    aux = {
        "explained_variance": v[:p],
        "objective": (coef * beta_mle.beta_nll_terms(v, **kw)).sum(),
        "iterations": it,
        "weights": c,
        "m": m,
    }
    return c, aux


def _fa_weights_rank_p(K: torch.Tensor, cfg: FlagConfig,
                       mask: torch.Tensor | None = None):
    p = K.shape[0]
    dev, dt = K.device, K.dtype
    m = cfg.m if cfg.m is not None else default_m(p)
    if m > p:
        raise ValueError(
            f"rank-p solver needs subspace dim m={m} <= p={p} (every FA "
            "subspace lies in span(G))")
    eps = cfg.eps
    Kt, nu = _normalized_gram(K, eps, mask)
    has_pairs = _has_pairs(cfg, p)
    wa = _active_count(mask, p, dev)
    delta = 10.0 * eps                  # Cholesky jitter, also in the pairs
    eye = torch.eye(p, dtype=dt, device=dev)

    # Pair geometry D~^2_ij = 2 - 2 Kt_ij, normalized in the jittered metric
    # 1 / (D~^2 + 2 delta); degenerate pairs get 0 (see the JAX solver).
    if has_pairs:
        d2 = torch.clamp(2.0 - 2.0 * Kt, min=0.0)
        inv_d2 = torch.where(d2 > 1e-12, 1.0 / (d2 + 2.0 * delta),
                             torch.zeros_like(d2))
        inv_d2 = inv_d2 - torch.diag(torch.diagonal(inv_d2))
        coef_pair = (cfg.lam / torch.clamp(wa - 1.0, min=1.0)).to(dt)
        pair_mask = torch.triu(torch.ones((p, p), dtype=dt, device=dev),
                               diagonal=1)
    else:
        inv_d2 = torch.zeros((p, p), dtype=dt, device=dev)
        coef_pair = torch.zeros((), dtype=dt, device=dev)
        pair_mask = torch.zeros((p, p), dtype=dt, device=dev)
    coef_data = torch.ones((p,), dtype=dt, device=dev)
    if mask is not None:
        mm = mask[:, None] * mask[None, :]
        inv_d2 = inv_d2 * mm
        pair_mask = pair_mask * mm
        coef_data = mask.to(dt)

    # Kt + delta I = L L^T.  cholesky_ex: no host sync for the error check
    # (a failed factor yields non-finite weights, as JAX's NaN does; so
    # does non-finite input to eigh, see nan_on_nonfinite).
    L, _ = torch.linalg.cholesky_ex(Kt + delta * eye)
    LinvK = torch.linalg.solve_triangular(L, Kt, upper=False)

    def assemble_h(u_data, u_pairs):
        """H(u) = diag(u_data) + Laplacian(edge weights u_ij / D~^2_ij)."""
        Ew = u_pairs * inv_d2
        return torch.diag(u_data + Ew.sum(dim=1)) - Ew

    def eig_top_m(u_data, u_pairs):
        Mp = L.T @ (assemble_h(u_data, u_pairs) @ L)
        _, Q = nan_on_nonfinite(torch.linalg.eigh, 0.5 * (Mp + Mp.T))
        return Q[:, -m:]                                # ascending: top m

    def explained(Qm):
        Z = Qm.T @ LinvK                                # (m, p)
        v_data = torch.clamp((Z * Z).sum(dim=0), 0.0, 1.0)
        ZtZ = Z.T @ Z
        pd2 = torch.clamp(v_data[:, None] + v_data[None, :] - 2.0 * ZtZ,
                          min=0.0)
        v_pairs = torch.clamp(pd2 * inv_d2, 0.0, 1.0)
        return v_data, v_pairs

    def irls(v_data, v_pairs):
        kw = dict(alpha=cfg.alpha, beta=cfg.beta, a=cfg.a, eps=eps)
        return (beta_mle.irls_weights(v_data, coef_data, **kw),
                beta_mle.irls_weights(v_pairs, coef_pair, **kw))

    Qm = eig_top_m(coef_data, torch.full((p, p), 1.0, dtype=dt, device=dev)
                   * coef_pair)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(cfg.n_iter):
        Qn = eig_top_m(*irls(*explained(Qm)))
        c2 = 2.0 * (m - ((Qm.T @ Qn) ** 2).sum())
        Qm = torch.where(done, Qm, Qn)
        it = it + (~done).to(torch.int32)
        done = done | (c2 < cfg.tol)

    nu_eff = effective_norms(nu, cfg.norm_mode, mask)
    s = torch.linalg.solve_triangular(L, (Kt @ nu_eff)[:, None], upper=False)
    ct = torch.linalg.solve_triangular(L.T, Qm @ (Qm.T @ s), upper=True)[:, 0]
    c = ct / (nu * wa)
    if mask is not None:
        c = c * mask
    if cfg.renormalize:
        c = c / torch.clamp(c.sum().abs(), min=1e-6)

    v_data, v_pairs = explained(Qm)
    nll = partial(beta_mle.beta_nll_terms, alpha=cfg.alpha, beta=cfg.beta,
                  a=cfg.a, eps=eps)
    objective = (coef_data * nll(v_data)).sum()
    if has_pairs:
        objective = objective + coef_pair * (pair_mask * nll(v_pairs)).sum()
    aux = {
        "explained_variance": v_data,
        "objective": objective,
        "iterations": it,
        "weights": c,
        "m": m,
    }
    return c, aux


def fa_weights_from_gram(K: torch.Tensor, cfg: FlagConfig = FlagConfig(), *,
                         solver: str = "rank_p",
                         mask: torch.Tensor | None = None):
    """FA combination weights c from the Gram matrix only.

    Args:
      K: (p, p) Gram of raw worker gradients, K_ij = g_i . g_j.
      cfg: FA hyper-parameters.
      solver: ``'rank_p'`` (p x p eigh per IRLS iteration) or ``'qspace'``
        (the q x q oracle, q = p + p(p-1)/2).
      mask: optional (p,) active-worker membership (bool or 0/1 float, kept
        on the device).  Inactive workers become zero-coefficient phantom
        columns and get c = 0.
    Returns:
      (c, aux): c (p,) fp32 with d = sum_w c_w g_w reproducing Algorithm
      1's update; aux holds the explained variances, IRLS iterations and
      the objective.
    """
    K = K.to(torch.float32)
    if mask is not None:
        mask = mask.to(torch.float32)
    if solver == "rank_p":
        return _fa_weights_rank_p(K, cfg, mask)
    if solver == "qspace":
        return _fa_weights_qspace(K, cfg, mask)
    raise ValueError(f"unknown solver {solver!r}; have {SOLVERS}")


def flag_aggregate_gram(G: torch.Tensor, cfg: FlagConfig = FlagConfig(), *,
                        solver: str = "rank_p"):
    """Single-host convenience for G (n, p): d = G @ c with c from
    ``fa_weights_from_gram(G^T G)``; returns (d, aux)."""
    c, aux = fa_weights_from_gram(gram_matrix(G), cfg, solver=solver)
    return G @ c.to(G.dtype), aux
