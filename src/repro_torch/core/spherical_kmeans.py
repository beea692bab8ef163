"""Spherical k-means (paper Appendix A) with k-means++ initialization
(port of ``repro/core/spherical_kmeans.py``).

Finds unit-norm centers mu_c maximizing sum_i max_c <x_i/||x_i||, mu_c>
with the EM iterations (23)-(24). The assignment step -- tags and max
similarities of every row -- is the ``kmeans_assign`` kernel; the center
update is a one-hot product. Empty clusters are re-seeded at the globally
worst-served points, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.kmeans_assign import kmeans_assign

__all__ = ["KMeansState", "normalize_rows", "assign", "kmeanspp_init", "fit"]


class KMeansState(NamedTuple):
    centers: torch.Tensor  # (C, D), unit rows
    inertia: float         # mean max-cosine objective (Eq. 22)


# rows a chunk of normalize_rows' squared norms
NORM_CHUNK = 1 << 20


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x / ||x||`` row by row. The squared norms of a 2-D ``x`` are
    summed ``NORM_CHUNK`` rows at a time, so the only (n, D) tensor made is
    the result (at 13M x 512 rows a whole ``x * x`` would take 26.6 GB
    more)."""
    if x.dim() == 2:
        n2 = torch.cat([torch.sum(c * c, dim=-1, keepdim=True)
                        for c in torch.split(x, NORM_CHUNK)])
    else:
        n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(n2, min=eps))


def assign(x_unit: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Cluster tags via Eq. (14)/(23): argmax_c <x_i, mu_c>. (n,) int32."""
    return kmeans_assign(x_unit, centers)[0]


def kmeanspp_init(x_unit: torch.Tensor, c: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """k-means++ seeding on the sphere (D^2 distance = 2 - 2 cos). The
    generator must live on ``x_unit``'s device."""
    n = x_unit.shape[0]
    first = int(torch.randint(0, n, (1,), device=x_unit.device,
                              generator=generator))
    centers = torch.zeros((c, x_unit.shape[1]), dtype=x_unit.dtype,
                          device=x_unit.device)
    centers[0] = x_unit[first]
    min_d2 = 2.0 - 2.0 * (x_unit @ centers[0])
    for i in range(1, c):
        probs = torch.clamp(min_d2, min=0.0)
        probs = probs / torch.clamp(probs.sum(), min=1e-12)
        idx = int(torch.multinomial(probs, 1, generator=generator))
        centers[i] = x_unit[idx]
        min_d2 = torch.minimum(min_d2, 2.0 - 2.0 * (x_unit @ centers[i]))
    return centers


def fit(x: torch.Tensor, c: int, n_iters: int = 25,
        generator: Optional[torch.Generator] = None,
        init_centers: Optional[torch.Tensor] = None,
        device=None) -> KMeansState:
    """Run spherical k-means on ``x: (n, D)`` (not necessarily normalized).

    ``init_centers`` (C, D) replaces the k-means++ start (tests pass the
    reference's start so both packages iterate from the same point);
    otherwise ``kmeanspp_init`` draws it from ``generator``."""
    dev = resolve_device(device)
    x_unit = normalize_rows(torch.as_tensor(x, dtype=torch.float32,
                                            device=dev))
    if init_centers is None:
        centers = kmeanspp_init(x_unit, c, generator)
    else:
        centers = torch.as_tensor(init_centers, dtype=torch.float32,
                                  device=dev).clone()
    for _ in range(n_iters):
        tags, maxsim = kmeans_assign(x_unit, centers.contiguous())
        # Eq. (24) numerator as one one-hot product, like the reference: a
        # fixed summation order, so a fit repeats bit for bit (a scatter-add
        # would sum in atomic order on the GPU)
        onehot = F.one_hot(tags.to(torch.int64), c).to(torch.float32)
        sums = onehot.T @ x_unit
        counts = onehot.sum(dim=0)
        worst = torch.argsort(maxsim, stable=True)[:c]
        reseed = x_unit[worst]
        norms = torch.linalg.norm(sums, dim=-1, keepdim=True)
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp(norms, min=1e-12), reseed)
        centers = normalize_rows(new)
    inertia = float(kmeans_assign(x_unit, centers.contiguous())[1].mean())
    return KMeansState(centers=centers, inertia=inertia)
