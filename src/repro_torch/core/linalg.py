"""Linear-algebra primitives of the LeanVec/GleanVec fits (port of
``repro/core/linalg.py``).

Everything works on second-moment (Gram) matrices, so the data-touching
part is one matmul and the O(D^3) part is a (D, D) ``torch.linalg.eigh``.
Eigenvector signs and the order of tied eigenvalues differ between
backends; compare fits by the subspaces they span, not by raw vectors.
"""
from __future__ import annotations

import torch

__all__ = ["second_moment", "cross_moment", "safe_inv_sqrt_spectrum",
           "sphering_from_moment", "topk_eigvecs", "orthonormalize_rows",
           "polar"]


def second_moment(x: torch.Tensor) -> torch.Tensor:
    """K = sum_i x_i x_i^T for row-major ``x: (n, D)`` -> ``(D, D)``."""
    x = x.to(torch.float32)
    return x.T @ x


def cross_moment(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted moment ``sum_i w_i x_i x_i^T`` with per-row weights
    ``w: (n,)``."""
    x = x.to(torch.float32)
    return (x * w.to(torch.float32)[:, None]).T @ x


def safe_inv_sqrt_spectrum(s: torch.Tensor, rel_eps: float = 1e-4
                           ) -> torch.Tensor:
    """Pseudo-inverse-safe 1/s for a spectrum ``s >= 0``: entries at or
    below ``rel_eps * max(s)`` map to 0 (the paper's pseudoinverse)."""
    cutoff = rel_eps * torch.max(s)
    keep = s > cutoff
    return torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))


def sphering_from_moment(k_q: torch.Tensor, rel_eps: float = 1e-4):
    """``W = U S U^T`` and its pseudo-inverse from ``k_q = U S^2 U^T``.

    Returns ``(W, W_pinv)``, both ``(D, D)`` symmetric PSD."""
    evals, u = torch.linalg.eigh(k_q.to(torch.float32))
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    w = (u * s[None, :]) @ u.T
    w_pinv = (u * safe_inv_sqrt_spectrum(s, rel_eps)[None, :]) @ u.T
    return w, w_pinv


def topk_eigvecs(m: torch.Tensor, d: int) -> torch.Tensor:
    """Top-``d`` eigenvectors of symmetric ``m: (D, D)`` as rows ``(d, D)``,
    by decreasing eigenvalue."""
    evals, vecs = torch.linalg.eigh(m.to(torch.float32))   # ascending
    order = torch.argsort(-evals)
    return vecs[:, order[:d]].T.contiguous()


def polar(a: torch.Tensor) -> torch.Tensor:
    """Polar factor ``U V^T`` of ``a (d, D)`` from its thin SVD: the LMO
    direction over the unit spectral-norm ball (the convex hull of the
    Stiefel manifold), and the nearest row-orthonormal matrix to ``a``."""
    u, _, vt = torch.linalg.svd(a, full_matrices=False)
    return u @ vt


def orthonormalize_rows(a: torch.Tensor) -> torch.Tensor:
    """Project ``a: (d, D)`` onto St(D, d) (row-orthonormal):
    argmin_{U in St} ||U - a||_F, the polar factor."""
    return polar(a)
