"""Baselines the paper compares against (Section 5.1, Figures 4-5; port of
``repro/core/baselines.py``).

* ``svd_fit``       -- query-agnostic SVD/PCA of the database (the "SVD"
                       curve): A = B = top-d eigenvectors of K_X.
* ``leanvec_fw``    -- LeanVec-FW: block-coordinate descent on Problem (3),
                       each block solved with Frank-Wolfe over the convex
                       hull of the Stiefel manifold (the unit spectral-norm
                       ball, whose LMO is minus the polar factor of the
                       gradient).
* ``leanvec_es``    -- LeanVec-ES: eigensearch over alpha for the top-d
                       eigenbasis of (1-a) K_X/tr(K_X) + a K_Q/tr(K_Q),
                       used for both A and B.
* ``leanvec_es_fw`` -- the ES solution refined by FW.

All work on the (D, D) second moments K_Q and K_X. The Frank-Wolfe blocks
take the gradient in closed form (the loss is a quadratic in each block):
with M = A^T B - I and G = K_Q M K_X + K_Q^T M K_X^T,

    dL/dA = B G^T,     dL/dB = A G,

where the reference differentiates the loss with ``jax.value_and_grad``.
Eigenvector signs and tie order differ between backends (and FW is
equivariant under the sign flips of its SVD start): compare fits by A^T B
and by their losses, never by raw A or B.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import linalg

__all__ = ["LinearDR", "svd_fit", "leanvec_fw", "leanvec_es",
           "leanvec_es_fw", "leanvec_loss_from_moments"]


class LinearDR(NamedTuple):
    """A generic linear query/database projection pair, (d, D) each."""

    a: torch.Tensor
    b: torch.Tensor

    @property
    def dim(self) -> int:
        return self.a.shape[0]


def _residual(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.T @ b - torch.eye(a.shape[1], dtype=a.dtype, device=a.device)


def leanvec_loss_from_moments(a, b, k_q, k_x) -> torch.Tensor:
    """Problem (3) loss via moments:

    L(A, B) = sum_q sum_x (<Aq, Bx> - <q, x>)^2
            = tr((A^T B - I)^T K_Q (A^T B - I) K_X).
    """
    m = _residual(a, b)
    return torch.trace(m.T @ k_q @ m @ k_x)


def svd_fit(k_x: torch.Tensor, d: int) -> LinearDR:
    """Query-agnostic PCA: A = B = top-d eigenvectors of K_X."""
    p = linalg.topk_eigvecs(k_x, d)
    return LinearDR(a=p, b=p)


def _normalized(k_q, k_x):
    """Moments scaled to unit trace, so FW step sizes are scale-free."""
    k_q = k_q.to(torch.float32)
    k_x = k_x.to(torch.float32)
    return k_q / torch.trace(k_q), k_x / torch.trace(k_x)


def _fw_block(loss_fn, grad_fn, var, n_iters: int):
    """Frank-Wolfe over the unit spectral-norm ball for one BCD block.

    Each block subproblem is a convex quadratic, so the line search is
    exact: along v + g (s - v) the loss is a quadratic in g, and g* =
    clip(-b / 2a, 0, 1) with b = <grad, s - v>, a = L(s) - L(v) - b (g = 1
    where a <= 0 and b < 0, else 0)."""
    v = var
    for _ in range(n_iters):
        lv, g = loss_fn(v), grad_fn(v)
        s = -linalg.polar(g)                # LMO over {||S||_2 <= 1}
        direction = s - v
        b = torch.sum(g * direction)
        a = loss_fn(s) - lv - b
        gamma = torch.clamp(-b / (2.0 * a + 1e-30), 0.0, 1.0)
        gamma = torch.where(a > 0, gamma,
                            torch.where(b < 0, torch.ones_like(b),
                                        torch.zeros_like(b)))
        v = v + gamma * direction
    return v


def _bcd(k_qn, k_xn, a, b, n_bcd: int, n_fw: int) -> LinearDR:
    """Block-coordinate descent: FW on A with B fixed, then on B."""

    def loss(a_, b_):
        return leanvec_loss_from_moments(a_, b_, k_qn, k_xn)

    def grad_m(a_, b_):
        m = _residual(a_, b_)
        return k_qn @ m @ k_xn + k_qn.T @ m @ k_xn.T

    for _ in range(n_bcd):
        a = _fw_block(lambda v: loss(v, b), lambda v: b @ grad_m(v, b).T,
                      a, n_fw)
        b = _fw_block(lambda v: loss(a, v), lambda v: a @ grad_m(a, v),
                      b, n_fw)
    # Iterates live in conv(St(D, d)). Only A^T B matters for the ranking,
    # and a final Stiefel retraction degrades the converged product badly
    # (the reference's NOTE), so the relaxed solution is returned as is.
    return LinearDR(a=a, b=b)


def leanvec_fw(k_q: torch.Tensor, k_x: torch.Tensor, d: int, n_bcd: int = 8,
               n_fw: int = 10) -> LinearDR:
    """LeanVec-FW, started from the query-agnostic SVD."""
    p0 = linalg.topk_eigvecs(k_x, d)
    k_qn, k_xn = _normalized(k_q, k_x)
    return _bcd(k_qn, k_xn, p0, p0, n_bcd, n_fw)


def leanvec_es(k_q: torch.Tensor, k_x: torch.Tensor, d: int,
               n_alphas: int = 17) -> LinearDR:
    """LeanVec-ES: on a grid of ``n_alphas`` values of alpha in [0, 1],
    the joint subspace P(alpha) of least Problem-(3) loss; A = B = P.
    Ties go to the smallest alpha, as ``jnp.argmin``."""
    k_qn, k_xn = _normalized(k_q, k_x)
    best_loss, best_p = None, None
    for alpha in torch.linspace(0.0, 1.0, n_alphas).tolist():
        p = linalg.topk_eigvecs((1.0 - alpha) * k_xn + alpha * k_qn, d)
        loss = float(leanvec_loss_from_moments(p, p, k_qn, k_xn))
        if best_loss is None or loss < best_loss:
            best_loss, best_p = loss, p
    return LinearDR(a=best_p, b=best_p)


def leanvec_es_fw(k_q: torch.Tensor, k_x: torch.Tensor, d: int,
                  n_bcd: int = 8, n_fw: int = 10,
                  n_alphas: int = 17) -> LinearDR:
    """LeanVec-ES+FW: the ES solution refined with FW BCD."""
    es = leanvec_es(k_q, k_x, d, n_alphas)
    k_qn, k_xn = _normalized(k_q, k_x)
    return _bcd(k_qn, k_xn, es.a, es.b, n_bcd, n_fw)
