"""Two-level rerank memory: the full-precision tier in host memory (port of
``repro/core/rerank_tier.py``).

The (n, D) float32 rerank store is D/d * 4 bytes a vector larger than the
int8 codes the scans stream, and it dominates device memory long before
the working set does: 2,000,000 x 512 x 4 B = 4.10 GB. Demoting it to host
memory keeps the reduced codes on the card and moves only the kappa
candidate rows of each query across PCIe.

* :class:`HostStore` holds the store as one CPU tensor, pinned when the
  serving device is CUDA (a pinning failure raises: the tier does not fall
  back to pageable memory). ``take`` gathers candidate rows with
  ``torch.index_select(..., out=)`` into the caller's staging buffer; torch
  runs that gather's rows in parallel with the GIL released, so a second
  serving thread keeps running.
* :class:`ShardedHostStore` keeps equal contiguous row shards as separate
  buffers (one per shard of a sharded placement) and routes global ids.
* :func:`fetch` is the one way rows leave a host tier for the device: a
  chunked gather into a staging buffer (pinned for the serving path),
  each chunk's non-blocking copy overlapping the next chunk's gather. The
  one-batch rerank and the engine's pipelined submit both call it.

Both are one opaque node of a state tree (:mod:`repro_torch.tree`): no
leaves, compared by (type, shape, dtype), so a store with new rows swaps
in and one with another shape is refused.

``set_rows`` keeps the reference's copy-on-write meaning -- the store it
was called on still reads its own rows, so a displaced state (a rollback
target, a snapshot being written) is unaffected -- without copying the
(n, D) buffer. The newest store of a history owns the buffer and writes in
place; before it does, the store it replaces keeps the rows it is about to
lose (a patch) and a link to its successor, and reads through the chain of
patches. A write from a store that is no longer the newest (after a
rollback) copies the buffer once and starts a new history.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["COPY_CHUNKS", "HostStore", "ShardedHostStore", "demote",
           "promote", "host_store", "host_arrays", "from_host_arrays",
           "fetch", "rows", "supports_pinned_host"]

# chunks of a batch's candidate rows: the H2D copy of one overlaps the host
# gather of the next
COPY_CHUNKS = 4


def _ids(ids) -> torch.Tensor:
    """Ids as a CPU int64 tensor."""
    if isinstance(ids, torch.Tensor):
        return ids.detach().to("cpu", torch.int64)
    return torch.as_tensor(np.asarray(ids), dtype=torch.int64)


def _owned(x, pin: bool) -> torch.Tensor:
    """A CPU copy of ``x`` that the store owns (a write never reaches the
    caller's array), in pinned memory when ``pin`` (raises if the pages
    cannot be pinned: no pageable fallback)."""
    x = x.detach() if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    if x.ndim != 2:
        raise ValueError(f"a host rerank store needs an (n, D) array, got "
                         f"shape {tuple(x.shape)}")
    out = torch.empty(tuple(x.shape), dtype=x.dtype, pin_memory=pin)
    return out.copy_(x)


class _HostTier:
    """Surface shared by the host stores."""

    def numpy(self) -> np.ndarray:
        return self._materialize().numpy()

    # identity for the state-tree check: (type, shape, dtype)
    def _aval(self):
        return (type(self).__name__, tuple(self.shape), str(self.dtype))

    def __eq__(self, other):
        return isinstance(other, _HostTier) and self._aval() == other._aval()

    def __hash__(self):
        return hash(self._aval())

    def __repr__(self):
        n, d = self.shape
        return (f"{type(self).__name__}(n={n}, D={d}, dtype={self.dtype}, "
                f"host_bytes={self.nbytes})")


class _Buffer:
    """The (n, D) buffer a history of :class:`HostStore` s shares, and the
    lock that orders a write against gathers from other threads."""

    def __init__(self, x: torch.Tensor):
        self.x = x
        self.lock = threading.Lock()


class HostStore(_HostTier):
    """The (n, D) full-precision rerank tier in one host buffer."""

    def __init__(self, x, pin: bool = False):
        self._buf = _Buffer(_owned(x, pin))
        self._patch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._next: Optional["HostStore"] = None

    @classmethod
    def _successor(cls, buf: _Buffer) -> "HostStore":
        s = cls.__new__(cls)
        s._buf, s._patch, s._next = buf, None, None
        return s

    @property
    def x(self) -> torch.Tensor:
        """This store's rows as one tensor: the shared buffer itself for
        the newest store of a history, a patched copy otherwise."""
        return self._materialize()

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self._buf.x.shape)

    @property
    def dtype(self):
        return self._buf.x.dtype

    @property
    def nbytes(self) -> int:
        return self._buf.x.numel() * self._buf.x.element_size()

    @property
    def pinned(self) -> bool:
        return self._buf.x.is_pinned()

    def _chain(self):
        """Patches from this store to the newest, nearest first."""
        out, s = [], self
        while s._next is not None:
            out.append(s._patch)
            s = s._next
        return out

    @staticmethod
    def _apply(out: torch.Tensor, ids: torch.Tensor, chain) -> None:
        # farthest patch first, so the nearest (this store's own) wins
        for pids, prows in reversed(chain):
            pos = torch.searchsorted(pids, ids).clamp_max(pids.numel() - 1)
            hit = pids[pos] == ids
            if bool(hit.any()):
                out[hit] = prows[pos[hit]]

    def _materialize(self) -> torch.Tensor:
        with self._buf.lock:
            chain = self._chain()
            if not chain:
                return self._buf.x
            out = self._buf.x.clone()
            self._apply(out, torch.arange(out.shape[0]), chain)
            return out

    def take(self, ids, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rows of external ``ids`` (any shape; -1 pads read row 0, which
        callers mask), as a (..., D) CPU tensor, written into ``out`` (a
        contiguous staging buffer of that many rows) when given."""
        ids = _ids(ids)
        flat = ids.reshape(-1).clamp_min(0)
        d = self.shape[1]
        dst = None if out is None else out.view(-1, d)[:flat.numel()]
        with self._buf.lock:
            got = torch.index_select(self._buf.x, 0, flat, out=dst)
            chain = self._chain()
            if chain:
                self._apply(got, flat, chain)
        return got.view(*ids.shape, d)

    def set_rows(self, ids, rows) -> "HostStore":
        """A store whose ``ids`` rows hold ``rows``; this store keeps its
        own (see the module docstring)."""
        ids = _ids(ids).reshape(-1)
        rows = torch.as_tensor(rows).detach().to("cpu", self.dtype) \
            .reshape(ids.numel(), -1)
        with self._buf.lock:
            if self._next is None:
                uniq = torch.unique(ids)                    # sorted
                self._patch = (uniq, self._buf.x.index_select(0, uniq))
                new = HostStore._successor(self._buf)
                self._next = new
                self._buf.x.index_copy_(0, ids, rows)
                return new
        # a displaced store (a rollback target) starts a history of its own
        new = HostStore(self._materialize(), pin=self.pinned)
        new._buf.x.index_copy_(0, ids, rows)
        return new


class ShardedHostStore(_HostTier):
    """The rerank tier of a sharded placement: equal contiguous row shards
    (shard s owns global rows [s * per, (s + 1) * per)) in separate host
    buffers; ``take`` routes global ids to their shard. ``set_rows`` copies
    the shards it touches."""

    def __init__(self, shards: Sequence, pin: bool = False):
        self.shards = tuple(_owned(s, pin) for s in shards)
        if not self.shards:
            raise ValueError("ShardedHostStore needs >= 1 shard")
        if len({tuple(s.shape) for s in self.shards}) != 1:
            raise ValueError("shards must be equal contiguous row splits; "
                             f"got shapes {[tuple(s.shape) for s in self.shards]}")
        self.per = self.shards[0].shape[0]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.per * len(self.shards), self.shards[0].shape[1])

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.shards)

    @property
    def pinned(self) -> bool:
        return self.shards[0].is_pinned()

    def _materialize(self) -> torch.Tensor:
        return torch.cat(self.shards, dim=0)

    def take(self, ids, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        ids = _ids(ids)
        flat = ids.reshape(-1).clamp_min(0)
        d = self.shape[1]
        got = torch.empty((flat.numel(), d), dtype=self.dtype) \
            if out is None else out.view(-1, d)[:flat.numel()]
        owner = torch.clamp_max(flat // self.per, self.n_shards - 1)
        for s, buf in enumerate(self.shards):
            sel = owner == s
            if bool(sel.any()):
                got[sel] = buf.index_select(0, flat[sel] - s * self.per)
        return got.view(*ids.shape, d)

    def set_rows(self, ids, rows) -> "ShardedHostStore":
        ids = _ids(ids).reshape(-1)
        rows = torch.as_tensor(rows).detach().to("cpu", self.dtype) \
            .reshape(ids.numel(), -1)
        owner = torch.clamp_max(ids // self.per, self.n_shards - 1)
        new = list(self.shards)
        for s in torch.unique(owner).tolist():
            sel = owner == s
            new[s] = _owned(new[s], self.pinned)
            new[s].index_copy_(0, ids[sel] - s * self.per, rows[sel])
        out = ShardedHostStore.__new__(ShardedHostStore)
        out.shards, out.per = tuple(new), self.per
        return out


def host_store(x) -> Optional[_HostTier]:
    """The host tier of an ``x_full``-like object, or None if it is a
    device tensor."""
    return x if isinstance(x, _HostTier) else None


def demote(x_full, shards: int = 0) -> Union[HostStore, ShardedHostStore]:
    """Move a full-precision store to host memory, pinned when it came
    from a CUDA tensor (the device it serves from). ``shards > 0`` splits
    it into that many equal contiguous row shards."""
    if isinstance(x_full, _HostTier):
        return x_full
    pin = isinstance(x_full, torch.Tensor) and x_full.is_cuda
    if shards:
        n = x_full.shape[0]
        if n % shards:
            raise ValueError(f"n={n} not divisible by shards={shards}")
        per = n // shards
        return ShardedHostStore([x_full[s * per:(s + 1) * per]
                                 for s in range(shards)], pin=pin)
    return HostStore(x_full, pin=pin)


def promote(x_full, device) -> torch.Tensor:
    """Inverse of :func:`demote`: all n rows as a tensor on ``device``."""
    store = host_store(x_full)
    if store is None:
        return x_full.to(device)
    return store._materialize().to(device)


def fetch(store: _HostTier, ids, device, staging=None, out=None,
          chunks: int = 1, events=None):
    """Rows of external ``ids`` (flattened; -1 reads row 0, which callers
    mask) of a host tier, on ``device``. The rows are gathered into
    ``staging`` (made when None: pinned when ``device`` is CUDA) in
    ``chunks`` chunks; on a CUDA device each chunk is copied into ``out``
    (made when None) by a non-blocking copy on the current stream while
    the next chunk is gathered, and ``events`` (a pair of timing events a
    chunk) bracket the copies. Returns ``(rows (n, D), gather seconds a
    chunk, bytes written into the rows)``: the bytes are added up chunk by
    chunk, so a copy larger than the candidate rows shows."""
    ids = _ids(ids).reshape(-1)
    n, d = ids.numel(), store.shape[1]
    cuda = torch.device(device).type == "cuda"
    if staging is None:
        staging = torch.empty((n, d), dtype=store.dtype, pin_memory=cuda)
    if cuda and out is None:
        out = torch.empty((n, d), dtype=store.dtype, device=device)
    dst = out if cuda else staging
    gathers, nbytes = [], 0
    step = max(1, -(-n // chunks))
    for c, lo in enumerate(range(0, n, step)):
        hi = min(lo + step, n)
        t0 = time.perf_counter()
        store.take(ids[lo:hi], out=staging[lo:hi])
        gathers.append(time.perf_counter() - t0)
        if cuda:
            if events is not None:
                events[c][0].record()
            out[lo:hi].copy_(staging[lo:hi], non_blocking=True)
            if events is not None:
                events[c][1].record()
        nbytes += (hi - lo) * d * dst.element_size()
    return dst[:n], gathers, nbytes


def rows(x_full, ids, device) -> torch.Tensor:
    """Rows of external ``ids`` of a rerank store on either tier, as a
    tensor on ``device``. A host tier's rows go through :func:`fetch`
    with a pageable staging buffer: these are bulk reads (inserts, a
    recall check, a refresh's moments), where pinning gigabytes for one
    call would cost more than the copy."""
    store = host_store(x_full)
    if store is None:
        return x_full[torch.as_tensor(ids, device=x_full.device).long()] \
            .to(device)
    ids = _ids(ids)
    staging = torch.empty((ids.numel(), store.shape[1]), dtype=store.dtype)
    got = fetch(store, ids, device, staging=staging)[0]
    return got.view(*ids.shape, store.shape[1])


def host_arrays(x_full) -> Optional[dict]:
    """Snapshot form of a host tier: a flat dict of CPU tensors the
    checkpoint writes straight from host memory (None for a device
    store, whose rows are ordinary leaves of the state)."""
    store = host_store(x_full)
    if store is None:
        return None
    if isinstance(store, ShardedHostStore):
        return {f"shard{s}": buf for s, buf in enumerate(store.shards)}
    return {"x": store.x}


def from_host_arrays(arrays: dict, pin: bool = False) -> _HostTier:
    """Rebuild a host tier from its :func:`host_arrays` form."""
    if set(arrays) == {"x"}:
        return HostStore(arrays["x"], pin=pin)
    return ShardedHostStore([arrays[k] for k in sorted(
        arrays, key=lambda k: int(k.replace("shard", "")))], pin=pin)


def supports_pinned_host() -> bool:
    """Whether host memory can be pinned for the card (a CUDA device is
    present); the CPU serves from host memory directly."""
    return torch.cuda.is_available()
