"""Batched vector-search serving engine (Algorithm 1 as a service; port of
``repro/serve/engine.py`` without the host-tier pipeline).

The engine serves ``state_search(queries (B, D), state) -> ids (B, k)`` at
a fixed batch size, pads the tail batch, and records per-batch latency.
PyTorch runs eagerly, so there is nothing to compile; the warm-up batch in
``__init__`` is where the CUDA kernels are built and loaded. ``swap``
installs a new state only if every tensor keeps its shape, dtype and
device and an index keeps its static configuration (an IVF index's
``nprobe`` and fine-step mode; a graph's ``beam``, ``max_hops``,
``expand``, ``fused`` and ``scan_tn``, and whether it carries
``nbr_rows``), so a swapped-in refresh serves through the same kernels at
the same shapes.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from dataclasses import dataclass
from typing import Deque, Optional

import numpy as np
import torch

from repro_torch.core import search as msearch

__all__ = ["ServeStats", "ServingEngine", "sanitize_queries"]


def sanitize_queries(queries: np.ndarray, dim: int):
    """Validate a query batch and zero rows holding non-finite values.

    Raises ``ValueError`` for a wrong shape or a non-numeric dtype. Returns
    ``(clean (n, dim) float32, bad_rows (n,) bool)``; callers answer the
    flagged rows with all ``-1`` ids."""
    queries = np.asarray(queries)
    if queries.ndim != 2 or queries.shape[1] != dim:
        raise ValueError(f"queries must be a (n, {dim}) array; got shape "
                         f"{queries.shape}")
    if not (np.issubdtype(queries.dtype, np.floating)
            or np.issubdtype(queries.dtype, np.integer)):
        raise ValueError(f"queries must be real-valued (float or int), got "
                         f"dtype {queries.dtype}")
    queries = queries.astype(np.float32, copy=False)
    bad_rows = ~np.isfinite(queries).all(axis=1)
    if bad_rows.any():
        queries = np.where(bad_rows[:, None], np.float32(0), queries)
    return queries, bad_rows


@dataclass
class ServeStats:
    """Serving counters; ``latencies_ms`` / ``swap_ms`` are ring buffers
    over the last ``window`` batches, the scalars are lifetime totals."""

    n_queries: int = 0
    n_batches: int = 0
    n_sanitized: int = 0
    total_s: float = 0.0
    window: int = 8192
    latencies_ms: Optional[Deque[float]] = None
    swap_ms: Optional[Deque[float]] = None

    def __post_init__(self):
        if self.latencies_ms is None:
            self.latencies_ms = collections.deque(maxlen=self.window)
        if self.swap_ms is None:
            self.swap_ms = collections.deque(maxlen=self.window)

    @property
    def qps(self) -> float:
        return self.n_queries / self.total_s if self.total_s else 0.0

    def percentile_ms(self, p: float) -> float:
        return float(np.percentile(np.asarray(self.latencies_ms, np.float64),
                                   p)) if self.latencies_ms else 0.0


_STATIC = (bool, int, float, str)


def _signature(obj):
    """Structure of a state: classes, and each tensor's shape, dtype and
    device, in field order. NamedTuples and dataclasses (indexes) are
    walked field by field; a dataclass's plain-valued fields (an IVF
    index's ``nprobe``, ``aligned_layout``) are static configuration and
    enter with their values."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return (type(obj).__name__,
                tuple((f, _signature(getattr(obj, f))) for f in obj._fields))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = []
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            fields.append((f.name, (type(v).__name__, v)
                           if isinstance(v, _STATIC) else _signature(v)))
        return (type(obj).__name__, tuple(fields))
    return (type(obj).__name__,)


class ServingEngine:
    """Serves ``state_search`` at a fixed batch size with a swappable state.

    ``state`` is a :class:`~repro_torch.core.search.ServingState`; its
    tensors live on the device the queries are sent to."""

    def __init__(self, state: msearch.ServingState, k: int, kappa: int,
                 batch_size: int, dim: int, stats_window: int = 8192):
        self.k = k
        self.kappa = kappa
        self.batch_size = batch_size
        self.dim = dim
        self.stats = ServeStats(window=stats_window)
        self.state = state
        self.n_swaps = 0
        self.device = state.artifacts.x_full.device
        # warm-up: builds and loads the kernels this state lowers to
        dummy = torch.zeros((batch_size, dim), dtype=torch.float32,
                            device=self.device)
        msearch.state_search(dummy, self.state, k, kappa).cpu()

    @property
    def version(self) -> int:
        return int(self.state.version)

    def _check_swap_compatible(self, state: msearch.ServingState) -> None:
        old, new = _signature(self.state), _signature(state)
        if old != new:
            raise ValueError("swap would change the state's structure, "
                             f"shapes or dtypes:\n  installed: {old}\n"
                             f"  offered:   {new}")

    def swap(self, state: msearch.ServingState) -> None:
        """Install ``state`` (same classes, tensor shapes, dtypes, devices;
        raises before touching the engine otherwise) and bump the
        version."""
        self._check_swap_compatible(state)
        t0 = time.perf_counter()
        self.n_swaps += 1
        self.state = state._replace(version=self.version + 1)
        self.stats.swap_ms.append((time.perf_counter() - t0) * 1e3)

    def submit(self, queries: np.ndarray) -> np.ndarray:
        """Answer all queries in fixed-size batches (the tail is padded).

        An empty batch returns ``(0, k)``; a malformed one raises
        ``ValueError``; rows with non-finite values are zeroed before
        batching and answered with all ``-1`` ids (``stats.n_sanitized``)."""
        queries = np.asarray(queries)
        if queries.size == 0 and queries.ndim <= 2:
            return np.zeros((0, self.k), np.int32)
        queries, bad_rows = sanitize_queries(queries, self.dim)
        if bad_rows.any():
            self.stats.n_sanitized += int(bad_rows.sum())
        out = []
        n = queries.shape[0]
        for s in range(0, n, self.batch_size):
            chunk = queries[s:s + self.batch_size]
            pad = self.batch_size - chunk.shape[0]
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            t0 = time.perf_counter()
            q = torch.as_tensor(chunk, device=self.device)
            ids = msearch.state_search(q, self.state, self.k,
                                       self.kappa).cpu().numpy()
            dt = time.perf_counter() - t0
            self.stats.n_batches += 1
            self.stats.n_queries += min(self.batch_size, n - s)
            self.stats.total_s += dt
            self.stats.latencies_ms.append(dt * 1e3)
            out.append(ids[: self.batch_size - pad])
        result = np.concatenate(out, axis=0).astype(np.int32, copy=False)
        if bad_rows.any():
            result[bad_rows] = -1
        return result
