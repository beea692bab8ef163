"""Evaluation metrics (paper Section 5, port of ``repro/core/metrics.py``)."""
from __future__ import annotations

import torch

__all__ = ["recall_at_k", "leanvec_loss", "ip_relative_error",
           "captured_variance_profile"]


def recall_at_k(retrieved, ground_truth) -> float:
    """K-recall@k = |S intersect G| / K, averaged over queries.

    ``retrieved``: (nq, k) ids; ``ground_truth``: (nq, K) ids (tensors or
    numpy arrays)."""
    retrieved = torch.as_tensor(retrieved).to(torch.int64)
    ground_truth = torch.as_tensor(ground_truth,
                                   device=retrieved.device).to(torch.int64)
    hits = retrieved[:, :, None] == ground_truth[:, None, :]
    per_query = hits.any(dim=1).sum(dim=-1).to(torch.float64)
    return float((per_query / ground_truth.shape[1]).mean())


def leanvec_loss(a: torch.Tensor, b: torch.Tensor, queries: torch.Tensor,
                 database: torch.Tensor) -> torch.Tensor:
    """Problem (3) loss ``sum_q sum_x (<Aq, Bx> - <q, x>)^2`` normalized
    per (q, x) pair, computed through the moments K_Q and K_X."""
    k_q = queries.T @ queries
    k_x = database.T @ database
    m = a.T @ b - torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    return torch.trace(m.T @ k_q @ m @ k_x) / (queries.shape[0]
                                               * database.shape[0])


def ip_relative_error(approx: torch.Tensor,
                      exact: torch.Tensor) -> torch.Tensor:
    """Mean |approx - exact| / (|exact| + eps) over a score matrix."""
    return torch.mean(torch.abs(approx - exact) / (torch.abs(exact) + 1e-6))


def captured_variance_profile(k_x: torch.Tensor) -> torch.Tensor:
    """Cumulative normalized eigenvalue profile of a moment (Figure 6,
    right), by decreasing eigenvalue."""
    evals = torch.sort(torch.linalg.eigvalsh(k_x), descending=True).values
    csum = torch.cumsum(torch.clamp(evals, min=0.0), dim=0)
    return csum / torch.clamp(csum[-1], min=1e-12)
