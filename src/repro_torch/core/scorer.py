"""Scorers: one database representation plus its scoring contract (port of
the static-serving part of ``repro/core/scorer.py``).

    qstate = scorer.prepare_queries(q)             # Alg. 1 line 1
    vals, ids = kernels.scorer_topk_prepared(scorer, qstate, k)

A scorer holds its encoded rows and prepares queries; the fused scan of
each scorer class lives in its CUDA kernel, lowered in one place,
:mod:`repro_torch.kernels` (``scorer_topk``), whose plain versions are the
scan on CPU tensors. The sorted scorers store a private tag-sorted row
order (``perm``: sorted row -> original id, -1 on padding) that the kernel
takes as its ``row_ids``, so ids come out in the original space.

    ==========================  =========================  ================
    scorer                      storage                    scoring
    ==========================  =========================  ================
    LinearScorer                f32 x_low = Bx (d dims)    <Aq, Bx>
    GleanVecScorer              f32 B_c x + tag (Alg. 4)   <A_c q, B_c x>
    QuantizedScorer             u8 codes of Bx + (d) scale <Aq*delta, u>+...
    GleanVecQuantizedScorer     u8 codes of B_c x + tag    per-cluster SQ
    SortedGleanVecScorer        f32 B_c x, tag-sorted      one view/block
    SortedGleanVecQuantized-    u8 codes, tag-sorted       per-cluster SQ,
    Scorer                                                 one view/block
    ==========================  =========================  ================

Streaming updates, gathered-id scoring and sharding belong to later parts
of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core import gleanvec as gv
from repro_torch.core import quantization as quant
from repro_torch.device import resolve_device

__all__ = [
    "LinearScorer", "GleanVecScorer", "QuantizedScorer",
    "GleanVecQuantizedScorer", "SortedGleanVecScorer",
    "SortedGleanVecQuantizedScorer", "QuantQueryState", "Scorer", "MODES",
    "build_scorer", "linear_scorer", "exact_scorer", "gleanvec_scorer",
    "quantized_scorer", "gleanvec_quantized_scorer",
    "sorted_gleanvec_scorer", "sorted_gleanvec_quantized_scorer",
]


class QuantQueryState(NamedTuple):
    """Prepared query for int8 scorers: the affine terms folded query-side.

    ``q_scaled``: (m, d) [linear] or (m, C, d) [per-cluster] = Aq * delta;
    ``q_lo``:     (m,)               or (m, C)              = <Aq, lo>.
    """

    q_scaled: torch.Tensor
    q_lo: torch.Tensor


def _views(a: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Eager per-cluster views A_c q: (m, C, d) from a (C, d, D)."""
    c, d, dim = a.shape
    q = queries.to(torch.float32)
    return (q @ a.reshape(c * d, dim).T).reshape(q.shape[0], c, d)


class LinearScorer(NamedTuple):
    """Linear DR scoring <Aq, Bx>; ``a=None`` is exact MIPS over ``x_low``
    (the 'full' mode, whose ``x_low`` is the full-precision database)."""

    x_low: torch.Tensor                 # (n, d)
    a: Optional[torch.Tensor] = None    # (d, D) query transform

    def prepare_queries(self, queries: torch.Tensor) -> torch.Tensor:
        q = queries.to(torch.float32)
        return q if self.a is None else q @ self.a.T


class GleanVecScorer(NamedTuple):
    """Eager GleanVec scoring (Alg. 4): tag-selected per-cluster views."""

    x_low: torch.Tensor                 # (n, d) = B_{tag_i} x_i
    tags: torch.Tensor                  # (n,) int32
    a: Optional[torch.Tensor] = None    # (C, d, D)

    def prepare_queries(self, queries: torch.Tensor) -> torch.Tensor:
        if self.a is None:
            raise ValueError("GleanVecScorer without `a` cannot prepare "
                             "queries; pass precomputed (m, C, d) views")
        return _views(self.a, queries)


class QuantizedScorer(NamedTuple):
    """Int8 SQ over linearly reduced vectors, per-dimension affine scales
    folded into the query: <q, u*delta + lo> = <q*delta, u> + <q, lo>."""

    codes: torch.Tensor                 # (n, d) uint8
    lo: torch.Tensor                    # (d,)
    delta: torch.Tensor                 # (d,)
    a: Optional[torch.Tensor] = None    # (d, D)

    def prepare_queries(self, queries: torch.Tensor) -> QuantQueryState:
        q = queries.to(torch.float32)
        if self.a is not None:
            q = q @ self.a.T
        return QuantQueryState(q_scaled=q * self.delta[None, :],
                               q_lo=q @ self.lo)


class GleanVecQuantizedScorer(NamedTuple):
    """GleanVec o int8: per-cluster int8 codes of B_c x, affine terms folded
    into the eager query views."""

    codes: torch.Tensor                 # (n, d) uint8
    tags: torch.Tensor                  # (n,) int32
    lo: torch.Tensor                    # (C, d)
    delta: torch.Tensor                 # (C, d)
    a: torch.Tensor                     # (C, d, D)

    def prepare_queries(self, queries: torch.Tensor) -> QuantQueryState:
        qv = _views(self.a, queries)                       # (m, C, d)
        return QuantQueryState(q_scaled=qv * self.delta[None],
                               q_lo=(qv * self.lo[None]).sum(dim=-1))


class SortedGleanVecScorer(NamedTuple):
    """Eager GleanVec over a tag-sorted, cluster-padded database: every
    ``layout_block`` rows share one tag."""

    x_low: torch.Tensor                 # (ns, d) sorted rows
    block_tags: torch.Tensor            # (ns // layout_block,) int32
    perm: torch.Tensor                  # (ns,) sorted row -> original id
    inv_perm: torch.Tensor              # (n,) original id -> sorted row
    a: Optional[torch.Tensor] = None    # (C, d, D)

    @property
    def layout_block(self) -> int:
        return self.x_low.shape[0] // self.block_tags.shape[0]

    def prepare_queries(self, queries: torch.Tensor) -> torch.Tensor:
        if self.a is None:
            raise ValueError("SortedGleanVecScorer without `a` cannot "
                             "prepare queries; pass precomputed (m, C, d) "
                             "views")
        return _views(self.a, queries)


class SortedGleanVecQuantizedScorer(NamedTuple):
    """GleanVec o int8 over the tag-sorted layout (same id translation as
    :class:`SortedGleanVecScorer`)."""

    codes: torch.Tensor                 # (ns, d) uint8, sorted
    block_tags: torch.Tensor            # (ns // layout_block,) int32
    perm: torch.Tensor                  # (ns,)
    inv_perm: torch.Tensor              # (n,)
    lo: torch.Tensor                    # (C, d)
    delta: torch.Tensor                 # (C, d)
    a: torch.Tensor                     # (C, d, D)

    @property
    def layout_block(self) -> int:
        return self.codes.shape[0] // self.block_tags.shape[0]

    def prepare_queries(self, queries: torch.Tensor) -> QuantQueryState:
        qv = _views(self.a, queries)
        return QuantQueryState(q_scaled=qv * self.delta[None],
                               q_lo=(qv * self.lo[None]).sum(dim=-1))


Scorer = Union[LinearScorer, GleanVecScorer, QuantizedScorer,
               GleanVecQuantizedScorer, SortedGleanVecScorer,
               SortedGleanVecQuantizedScorer]


# ---------------------------------------------------------------------------
# Factories: model + database -> scorer (the encode step, Alg. 1 line 0).
# ---------------------------------------------------------------------------


def exact_scorer(database: torch.Tensor) -> LinearScorer:
    """Full-precision exact MIPS (the 'full' mode / rerank oracle)."""
    return LinearScorer(x_low=database.to(torch.float32))


def linear_scorer(model, database: torch.Tensor) -> LinearScorer:
    """LeanVec-Sphering: x_low = Bx, queries mapped by A."""
    return LinearScorer(x_low=database.to(torch.float32) @ model.b.T,
                        a=model.a)


def gleanvec_scorer(model, database: torch.Tensor) -> GleanVecScorer:
    """GleanVec: tags + per-cluster reduced vectors."""
    tags, x_low = gv.encode_database(model, database)
    return GleanVecScorer(x_low=x_low, tags=tags, a=model.a)


def quantized_scorer(model, database: torch.Tensor,
                     bits: int = 8) -> QuantizedScorer:
    """LeanVec-Sphering + per-dimension int8 SQ of the reduced vectors."""
    db = quant.quantize(database.to(torch.float32) @ model.b.T, bits)
    return QuantizedScorer(codes=db.codes, lo=db.lo, delta=db.delta,
                           a=model.a)


def gleanvec_quantized_scorer(model, database: torch.Tensor,
                              bits: int = 8) -> GleanVecQuantizedScorer:
    """GleanVec + per-cluster int8 SQ of the reduced vectors."""
    tags, x_low = gv.encode_database(model, database)
    db = quant.quantize_per_cluster(x_low, tags, model.n_clusters, bits)
    return GleanVecQuantizedScorer(codes=db.codes, tags=tags, lo=db.lo,
                                   delta=db.delta, a=model.a)


def sorted_gleanvec_scorer(model, database: torch.Tensor,
                           block: int = 4096) -> SortedGleanVecScorer:
    """GleanVec in the tag-sorted layout (clusters padded to ``block``)."""
    tags, x_low = gv.encode_database(model, database)
    xs, block_tags, perm = gv.sort_by_tag(tags, x_low, block=block)
    return SortedGleanVecScorer(
        x_low=xs, block_tags=block_tags, perm=perm,
        inv_perm=gv.inverse_permutation(perm, x_low.shape[0]), a=model.a)


def sorted_gleanvec_quantized_scorer(model, database: torch.Tensor,
                                     block: int = 4096, bits: int = 8
                                     ) -> SortedGleanVecQuantizedScorer:
    """GleanVec + per-cluster int8 SQ in the tag-sorted layout: the same
    codes and scales as :func:`gleanvec_quantized_scorer` (quantize, then
    sort)."""
    tags, x_low = gv.encode_database(model, database)
    db = quant.quantize_per_cluster(x_low, tags, model.n_clusters, bits)
    cs, block_tags, perm = gv.sort_by_tag(tags, db.codes, block=block)
    return SortedGleanVecQuantizedScorer(
        codes=cs, block_tags=block_tags, perm=perm,
        inv_perm=gv.inverse_permutation(perm, x_low.shape[0]), lo=db.lo,
        delta=db.delta, a=model.a)


MODES = ("full", "sphering", "gleanvec", "sphering-int8", "gleanvec-int8",
         "gleanvec-sorted", "gleanvec-int8-sorted")


def build_scorer(mode: str, database, model=None, block: int = 4096,
                 device=None) -> Scorer:
    """Mode-string dispatch used by the serving layer. ``database`` (numpy
    or tensor) is moved to ``device`` (default: the GPU); ``block`` is the
    sorted layouts' per-cluster padding multiple."""
    dev = resolve_device(device)
    database = torch.as_tensor(database, dtype=torch.float32, device=dev)
    if mode == "full":
        return exact_scorer(database)
    if model is None:
        raise ValueError(f"mode {mode!r} needs a DR model")
    if mode == "sphering":
        return linear_scorer(model, database)
    if mode == "gleanvec":
        return gleanvec_scorer(model, database)
    if mode == "sphering-int8":
        return quantized_scorer(model, database)
    if mode == "gleanvec-int8":
        return gleanvec_quantized_scorer(model, database)
    if mode == "gleanvec-sorted":
        return sorted_gleanvec_scorer(model, database, block=block)
    if mode == "gleanvec-int8-sorted":
        return sorted_gleanvec_quantized_scorer(model, database, block=block)
    raise ValueError(f"unknown scorer mode {mode!r}; one of {MODES}")
