"""LeanVec-Sphering (paper Section 3, Algorithm 2; port of
``repro/core/leanvec_sphering.py``).

    W = U S U^T   (sphering, W^2 = Q Q^T),   P = top-d eigvecs of W K_X W,
    A = P W^+     (queries),                 B = P W   (database)

phrased on the second moments K_Q = Q Q^T and K_X = X X^T.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from repro_torch.core import linalg
from repro_torch.device import resolve_device

__all__ = ["SpheringModel", "fit", "fit_from_moments", "full_rotation_model"]


class SpheringModel(NamedTuple):
    """``a``: (d, D) query projection; ``b``: (d, D) database projection;
    ``p``: (d, D) Stiefel factor; ``w`` / ``w_pinv``: (D, D) sphering.

    With ``d == D`` (:func:`full_rotation_model`) every row prefix
    ``a[:d'], b[:d']`` is a valid reduced model (Section 3.1):
    :meth:`truncate` picks d at run time."""

    a: torch.Tensor
    b: torch.Tensor
    p: torch.Tensor
    w: torch.Tensor
    w_pinv: torch.Tensor

    @property
    def dim(self) -> int:
        return self.a.shape[0]

    def truncate(self, d: int) -> "SpheringModel":
        """Runtime selection of the target dimensionality (Section 3.1):
        the first ``d`` rows of ``a``, ``b`` and ``p``."""
        return SpheringModel(self.a[:d], self.b[:d], self.p[:d], self.w,
                             self.w_pinv)


def fit_from_moments(k_q: torch.Tensor, k_x: torch.Tensor, d: int,
                     rel_eps: float = 1e-4) -> SpheringModel:
    """Algorithm 2 on (D, D) second moments."""
    w, w_pinv = linalg.sphering_from_moment(k_q, rel_eps)
    m = w @ k_x @ w
    m = 0.5 * (m + m.T)            # re-symmetrize
    p = linalg.topk_eigvecs(m, d)
    return SpheringModel(a=p @ w_pinv, b=p @ w, p=p, w=w, w_pinv=w_pinv)


def fit(queries, database, d: int, rel_eps: float = 1e-4,
        device=None) -> SpheringModel:
    """Algorithm 2. ``queries: (m, D)``, ``database: (n, D)``.

    With fewer learning queries than dimensions K_Q is rank-deficient and
    the projection discards directions; this warns, as the reference does
    (the paper uses 10k learning queries)."""
    dev = resolve_device(device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    database = torch.as_tensor(database, dtype=torch.float32, device=dev)
    if queries.shape[0] < queries.shape[1]:
        warnings.warn(
            f"LeanVec-Sphering: {queries.shape[0]} learning queries for "
            f"D={queries.shape[1]} dims -- K_Q is rank-deficient and the "
            "sphering projection will discard directions; use m >= D "
            "queries (the paper uses 10k).", stacklevel=2)
    return fit_from_moments(linalg.second_moment(queries),
                            linalg.second_moment(database), d, rel_eps)


def full_rotation_model(queries, database, rel_eps: float = 1e-4,
                        device=None) -> SpheringModel:
    """Section 3.1: fit with ``d = D`` (every prefix is a valid model)."""
    return fit(queries, database, d=queries.shape[1], rel_eps=rel_eps,
               device=device)
