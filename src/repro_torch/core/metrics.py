"""Evaluation metrics (paper Section 5, port of ``repro/core/metrics.py``)."""
from __future__ import annotations

import torch

__all__ = ["recall_at_k"]


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
