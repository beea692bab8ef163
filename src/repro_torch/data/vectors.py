"""Synthetic statistical twins of the paper's datasets (Table 1).

A copy of the reference generator (``repro/data/vectors.py``): the same
numpy calls in the same order, so ``make_dataset`` gives bit-identical
database and query arrays for the same arguments.

* Database: a mixture of anisotropic Gaussians with low intrinsic
  dimensionality per component, embedded in D dims.
* ID queries: database rows plus small noise.
* OOD queries: a rotated covariance plus a mean shift, loosely anchored to
  database rows (the Figure 1 mechanism).

``make_dataset_device`` follows the same recipe with ``torch`` draws on a
device, chunk by chunk (other numbers than numpy's), for sizes whose host
copy would not fit: OI-13M's 13M x 512 f32 rows are 26.6 GB.

Ground truth is exact max-inner-product top-k. ``exact_topk`` computes it
in numpy, blocked over the database, as the reference does; with a torch
``device`` it computes the same blocked scan in torch on that device (much
faster at millions of rows on a GPU). The two give the same ids except
where two scores tie exactly (float sums in another order can also swap
neighbours whose scores differ in the last bit).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["VectorDataset", "DeviceDataset", "make_dataset", "make_mixture",
           "make_dataset_device", "exact_topk"]


class VectorDataset(NamedTuple):
    name: str
    database: np.ndarray       # (n, D) float32
    queries_learn: np.ndarray  # (m, D)
    queries_test: np.ndarray   # (m, D)
    gt: np.ndarray             # (m_test, k_gt) exact top-k ids (IP metric)
    ood: bool


def _component_basis(rng, d_full, d_intr, decay=0.85):
    """Random orthonormal basis scaled with geometric spectrum."""
    basis = np.linalg.qr(rng.standard_normal((d_full, d_full)))[0][:, :d_intr]
    scales = decay ** np.arange(d_intr)
    return basis * scales[None, :]


def make_mixture(rng, n, d_full, n_components=8, d_intr=None, spread=4.0):
    d_intr = d_intr or max(8, d_full // 6)
    assignments = rng.integers(0, n_components, size=n)
    means = rng.standard_normal((n_components, d_full)) * spread
    bases = [_component_basis(rng, d_full, d_intr)
             for _ in range(n_components)]
    out = np.empty((n, d_full), np.float32)
    for c in range(n_components):
        idx = np.where(assignments == c)[0]
        z = rng.standard_normal((idx.size, d_intr))
        out[idx] = (means[c][None, :] + z @ bases[c].T).astype(np.float32)
    return out, means, bases


def _exact_topk_numpy(queries, database, k, block):
    m = queries.shape[0]
    best_ids = np.zeros((m, k), np.int64)
    best_val = np.full((m, k), -np.inf, np.float32)
    for start in range(0, database.shape[0], block):
        blk = database[start:start + block]
        scores = queries @ blk.T                        # (m, b)
        joint_val = np.concatenate([best_val, scores], axis=1)
        joint_ids = np.concatenate(
            [best_ids, np.broadcast_to(np.arange(start, start + blk.shape[0]),
                                       (m, blk.shape[0]))], axis=1)
        sel = np.argpartition(-joint_val, k - 1, axis=1)[:, :k]
        best_val = np.take_along_axis(joint_val, sel, axis=1)
        best_ids = np.take_along_axis(joint_ids, sel, axis=1)
    order = np.argsort(-best_val, axis=1)
    return np.take_along_axis(best_ids, order, axis=1)


def _exact_topk_torch(queries, database, k, block, device):
    import torch
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    m = q.shape[0]
    best_val = torch.full((m, k), float("-inf"), device=device)
    best_ids = torch.zeros((m, k), dtype=torch.int64, device=device)
    for start in range(0, database.shape[0], block):
        blk = torch.as_tensor(database[start:start + block],
                              dtype=torch.float32, device=device)
        scores = q @ blk.T
        ids = torch.arange(start, start + blk.shape[0], device=device)
        joint_val = torch.cat([best_val, scores], dim=1)
        joint_ids = torch.cat([best_ids, ids.expand(m, -1)], dim=1)
        best_val, sel = torch.topk(joint_val, k, dim=1)
        best_ids = torch.gather(joint_ids, 1, sel)
    return best_ids.cpu().numpy()


def exact_topk(queries: np.ndarray, database: np.ndarray, k: int,
               block: int = 8192, device=None) -> np.ndarray:
    """Exact MIPS ground truth ``(m, k)`` int64 ids, best first.

    ``device=None`` runs the reference's numpy scan; a torch device runs
    the same blocked scan in torch there (see the module docstring for
    where the two may differ)."""
    if device is None:
        return _exact_topk_numpy(queries, database, k, block)
    return _exact_topk_torch(queries, database, k, max(block, 65536), device)


def make_dataset(name: str, n: int, d: int, n_queries: int = 512,
                 ood: bool = False, k_gt: int = 100, seed: int = 0,
                 n_components: int = 8, gt_device=None) -> VectorDataset:
    """The reference's generator. ``gt_device`` picks where the ground
    truth is computed (``None`` = numpy on the host, as the reference)."""
    rng = np.random.default_rng(seed)
    database, means, bases = make_mixture(rng, n, d,
                                          n_components=n_components)

    if not ood:
        # ID: database rows plus mild noise. (The reference also draws an
        # unused mixture from a separate generator; it does not touch
        # ``rng``, so leaving it out keeps the arrays identical.)
        idx = rng.integers(0, n, size=2 * n_queries)
        q_all = database[idx] + 0.05 * rng.standard_normal(
            (2 * n_queries, d)).astype(np.float32)
    else:
        # OOD: rotated principal axes + mean shift (Fig. 1 mechanism).
        rot = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
        d_intr = max(8, d // 8)
        q_basis = _component_basis(rng, d, d_intr, decay=0.8)
        z = rng.standard_normal((2 * n_queries, d_intr))
        shift = rng.standard_normal(d) * 2.0
        q_all = ((z @ q_basis.T) @ rot + shift[None, :]).astype(np.float32)
        anchor = database[rng.integers(0, n, size=2 * n_queries)]
        q_all = (0.6 * q_all + 0.4 * anchor).astype(np.float32)

    q_learn, q_test = q_all[:n_queries], q_all[n_queries:]
    gt = exact_topk(q_test, database, k_gt, device=gt_device)
    return VectorDataset(name=name, database=database, queries_learn=q_learn,
                         queries_test=q_test, gt=gt, ood=ood)


class DeviceDataset(NamedTuple):
    """:func:`make_dataset_device`'s tensors, on the generator's device."""
    database: "torch.Tensor"        # (n, D) float32
    queries_learn: "torch.Tensor"   # (m_learn, D)
    queries_test: "torch.Tensor"    # (m_test, D)


def _component_basis_device(gen, d_full, d_intr, decay=0.85):
    import torch
    g = torch.randn((d_full, d_full), generator=gen, device=gen.device,
                    dtype=torch.float64)
    basis = torch.linalg.qr(g)[0][:, :d_intr]
    return basis * (decay ** torch.arange(d_intr, device=gen.device,
                                          dtype=torch.float64))[None, :]


# rows a chunk of make_dataset_device's database
DEVICE_CHUNK = 1 << 20


def make_dataset_device(n: int, d: int, n_learn: int, n_test: int,
                        generator, ood: bool = True, n_components: int = 8
                        ) -> DeviceDataset:
    """:func:`make_dataset`'s database and queries (no ground truth),
    drawn from ``generator`` on its device: a mixture of ``n_components``
    anisotropic Gaussians of intrinsic dimension max(8, D / 6) around
    means of scale 4 (``make_mixture``'s spread), made ``DEVICE_CHUNK``
    rows at a time (the only (n, D) tensor is the result); OOD queries
    from a rotated basis of intrinsic dimension max(8, D / 8) plus a mean
    shift, anchored 0.4 to random database rows (ID queries: rows plus
    0.05 noise). Bases and means are drawn in float64, the rows written
    in float32."""
    import torch
    gen, dev = generator, generator.device
    f64 = torch.float64
    d_intr = max(8, d // 6)
    assign = torch.randint(0, n_components, (n,), generator=gen, device=dev)
    means = torch.randn((n_components, d), generator=gen, device=dev,
                        dtype=f64) * 4.0
    bases = [_component_basis_device(gen, d, d_intr)
             for _ in range(n_components)]
    x = torch.empty((n, d), dtype=torch.float32, device=dev)
    for s in range(0, n, DEVICE_CHUNK):
        a = assign[s:s + DEVICE_CHUNK]
        z = torch.randn((a.numel(), d_intr), generator=gen, device=dev,
                        dtype=f64)
        for c in range(n_components):
            rows = torch.nonzero(a == c).squeeze(1)
            x[s + rows] = (means[c][None, :] + z[rows] @ bases[c].T).to(
                torch.float32)
    m = n_learn + n_test
    if not ood:
        idx = torch.randint(0, n, (m,), generator=gen, device=dev)
        q = x[idx] + 0.05 * torch.randn((m, d), generator=gen, device=dev)
    else:
        rot = torch.linalg.qr(torch.randn((d, d), generator=gen, device=dev,
                                          dtype=f64))[0]
        qd = max(8, d // 8)
        q_basis = _component_basis_device(gen, d, qd, decay=0.8)
        z = torch.randn((m, qd), generator=gen, device=dev, dtype=f64)
        shift = torch.randn(d, generator=gen, device=dev, dtype=f64) * 2.0
        q = ((z @ q_basis.T) @ rot + shift[None, :]).to(torch.float32)
        anchor = x[torch.randint(0, n, (m,), generator=gen, device=dev)]
        q = 0.6 * q + 0.4 * anchor
    return DeviceDataset(database=x, queries_learn=q[:n_learn].contiguous(),
                         queries_test=q[n_learn:].contiguous())
