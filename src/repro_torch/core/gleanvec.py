"""GleanVec (paper Section 4, Algorithm 5; port of ``repro/core/gleanvec.py``).

Learning: spherical k-means on the normalized database, partition by
Eq. (19), then LeanVec-Sphering per cluster sharing one sphering matrix W.
Encoding: x_i -> (c_i, B_{c_i} x_i) (Eq. 14-15). Queries: eager views
A_c q for every cluster (Alg. 4), or the lazy per-row A_{c_i} q (Alg. 3).

Three reference computations do not scale to millions of rows as written and
are restructured with the same arithmetic: the per-cluster moments are C
matmuls ``X_c^T X_c`` (not a three-operand einsum with an (n, C, D)
intermediate), and the encoding and the lazy inner products (Alg. 3) run
cluster by cluster (not over a gather of an (n, d, D) tensor of
projections).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import linalg, spherical_kmeans
from repro_torch.device import resolve_device

__all__ = ["GleanVecModel", "fit", "fit_from_moments", "per_cluster_moments",
           "assign_tags", "encode_database", "project_per_cluster",
           "sort_by_tag", "inverse_permutation", "project_queries_eager",
           "inner_products_lazy", "inner_products_eager"]


class GleanVecModel(NamedTuple):
    """``centers``: (C, D) unit landmarks; ``a``, ``b``: (C, d, D);
    ``w`` / ``w_pinv``: (D, D) shared sphering (query side)."""

    centers: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    w: torch.Tensor
    w_pinv: torch.Tensor

    @property
    def n_clusters(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.a.shape[1]

    def truncate(self, d: int) -> "GleanVecModel":
        """Runtime target-d selection, per cluster (Section 3.1 carries
        over): the first ``d`` rows of every ``a_c`` and ``b_c``."""
        return GleanVecModel(self.centers, self.a[:, :d], self.b[:, :d],
                             self.w, self.w_pinv)


def _cluster_rows(tags: torch.Tensor, c: int):
    """Row indices of each cluster, from one stable sort of the tags."""
    order = torch.argsort(tags.to(torch.int64), stable=True)
    counts = torch.bincount(tags.to(torch.int64), minlength=c).tolist()
    return torch.split(order, counts)


def per_cluster_moments(x: torch.Tensor, tags: torch.Tensor,
                        c: int) -> torch.Tensor:
    """K_X^c = sum_{x in X_c} x x^T for each cluster: (C, D, D)."""
    x = x.to(torch.float32)
    out = torch.zeros((c, x.shape[1], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for ci, rows in enumerate(_cluster_rows(tags, c)):
        if rows.numel():
            xc = x[rows]
            out[ci] = xc.T @ xc
    return out


def fit_from_moments(centers: torch.Tensor, k_q: torch.Tensor,
                     k_x_per_cluster: torch.Tensor, d: int,
                     rel_eps: float = 1e-4) -> GleanVecModel:
    """Per-cluster LeanVec-Sphering given precomputed moments."""
    w, w_pinv = linalg.sphering_from_moment(k_q, rel_eps)
    a, b = [], []
    for k_x_c in k_x_per_cluster:
        m = w @ k_x_c @ w
        m = 0.5 * (m + m.T)
        p = linalg.topk_eigvecs(m, d)
        a.append(p @ w_pinv)
        b.append(p @ w)
    return GleanVecModel(centers=centers, a=torch.stack(a), b=torch.stack(b),
                         w=w, w_pinv=w_pinv)


def fit(queries, database, c: int, d: int, kmeans_iters: int = 25,
        rel_eps: float = 1e-4, generator: Optional[torch.Generator] = None,
        init_centers=None, device=None) -> GleanVecModel:
    """Algorithm 5. ``queries: (m, D)``, ``database: (n, D)``.

    ``init_centers`` starts the k-means from given centers (the tests pass
    the reference's k-means++ start); otherwise ``generator`` seeds
    k-means++."""
    dev = resolve_device(device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    database = torch.as_tensor(database, dtype=torch.float32, device=dev)
    km = spherical_kmeans.fit(database, c, kmeans_iters, generator=generator,
                              init_centers=init_centers, device=dev)
    x_unit = spherical_kmeans.normalize_rows(database)
    tags = spherical_kmeans.assign(x_unit, km.centers.contiguous())
    del x_unit
    k_q = linalg.second_moment(queries)
    k_x_c = per_cluster_moments(database, tags, c)
    return fit_from_moments(km.centers, k_q, k_x_c, d, rel_eps)


def assign_tags(model: GleanVecModel, database: torch.Tensor) -> torch.Tensor:
    """Eq. (19) cluster assignment under the model's fixed landmarks."""
    x_unit = spherical_kmeans.normalize_rows(database.to(torch.float32))
    return spherical_kmeans.assign(x_unit, model.centers.contiguous())


def encode_database(model: GleanVecModel, database: torch.Tensor):
    """Eq. (14)-(15): ``(tags (n,) int32, x_low (n, d) f32)`` with
    ``x_low_i = B_{tags_i} x_i``, computed cluster by cluster."""
    database = database.to(torch.float32)
    tags = assign_tags(model, database)
    return tags, project_per_cluster(database, tags, model.b)


def project_per_cluster(x: torch.Tensor, tags: torch.Tensor,
                        mats: torch.Tensor,
                        src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = mats[tags[i]] @ x[src[i]]`` (``src`` defaults to ``i``):
    (n, d') f32 from ``mats (C, d', d)``, one ``(n_c, d) x (d, d')``
    product per cluster -- the reference's ``einsum("ndk,nk->nd",
    mats[tags], x)`` without its (n, d', d) gather. Encoding (``mats`` =
    B), the exact refresh re-encode and the Eq. 12 reprojection
    (``mats`` = the transition stack) all go through it."""
    out = torch.zeros((tags.shape[0], mats.shape[1]), dtype=torch.float32,
                      device=x.device)
    for ci, rows in enumerate(_cluster_rows(tags, mats.shape[0])):
        if rows.numel():
            xr = x[rows if src is None else src[rows]]
            out[rows] = xr.to(torch.float32) @ mats[ci].T
    return out


def project_queries_eager(model: GleanVecModel, queries: torch.Tensor):
    """Alg. 4 preprocess: all views q_c = A_c q, (m, C, d)."""
    c, d, dim = model.a.shape
    q = queries.to(torch.float32)
    return (q @ model.a.reshape(c * d, dim).T).reshape(q.shape[0], c, d)


def inner_products_lazy(model: GleanVecModel, query: torch.Tensor,
                        tags: torch.Tensor, x_low: torch.Tensor
                        ) -> torch.Tensor:
    """Alg. 3: scores ``<A_{c_i} q, x_low_i>`` of one ``query (D,)``
    against every row, (n,). Each cluster's view A_c q is made once and
    scores that cluster's rows (the reference gathers an (n, d, D) tensor
    of per-row projections)."""
    q = query.to(torch.float32)
    out = torch.zeros(tags.shape[0], dtype=torch.float32,
                      device=x_low.device)
    for ci, rows in enumerate(_cluster_rows(tags, model.n_clusters)):
        if rows.numel():
            out[rows] = x_low[rows].to(torch.float32) @ (model.a[ci] @ q)
    return out


def inner_products_eager(q_views: torch.Tensor, tags: torch.Tensor,
                         x_low: torch.Tensor) -> torch.Tensor:
    """Alg. 4: select the precomputed view ``q_views[tags_i]`` of one
    query (``q_views (C, d)``) for every row: (n,) scores."""
    return torch.sum(q_views[tags.long()] * x_low, dim=-1)


def sort_by_tag(tags: torch.Tensor, x_low: torch.Tensor, x_full=None,
                block: int = 4096, slack_blocks: int = 0):
    """Cluster-contiguous layout for the sorted scorers: rows sorted by tag
    (stable), each cluster padded with zero rows to a ``block`` multiple,
    so every block of the result carries one tag. ``slack_blocks`` appends
    that many extra all-padding blocks to every cluster (free slots for
    streaming inserts).

    Returns ``(x_sorted, block_tags (nb,) int32, perm (ns,) int32)`` with
    ``perm[sorted_row] = original id`` and -1 on padding rows; with
    ``x_full`` ((n, D), any dtype) a fourth entry, its rows in the same
    sorted order with zero padding rows. Clusters are laid out for tags
    0 .. max(tags), as in the reference."""
    dev = x_low.device
    t = tags.to(torch.int64)
    n = t.shape[0]
    c = int(t.max()) + 1 if n else 1
    counts = torch.bincount(t, minlength=c)
    padded = (counts + block - 1) // block * block + slack_blocks * block
    starts = torch.cumsum(padded, 0) - padded            # first row of cluster
    order = torch.argsort(t, stable=True)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - first[t[order]]
    dest = starts[t[order]] + rank                        # sorted row of order[i]
    ns = int(padded.sum())
    x_sorted = torch.zeros((ns, x_low.shape[1]), dtype=x_low.dtype, device=dev)
    x_sorted[dest] = x_low[order]
    perm = torch.full((ns,), -1, dtype=torch.int32, device=dev)
    perm[dest] = order.to(torch.int32)
    block_tags = torch.repeat_interleave(
        torch.arange(c, device=dev, dtype=torch.int32), padded // block)
    if x_full is None:
        return x_sorted, block_tags, perm
    full_sorted = torch.zeros((ns, x_full.shape[1]), dtype=x_full.dtype,
                              device=dev)
    full_sorted[dest] = x_full[order]
    return x_sorted, block_tags, perm, full_sorted


def inverse_permutation(perm: torch.Tensor, n: int) -> torch.Tensor:
    """``inv[original_id] = sorted row`` for a :func:`sort_by_tag` perm."""
    inv = torch.full((n,), -1, dtype=torch.int32, device=perm.device)
    valid = perm >= 0
    inv[perm[valid].to(torch.int64)] = torch.nonzero(valid).squeeze(1).to(
        torch.int32)
    return inv

