"""Flat (exact within the reduced space) search as functions (port of
``repro/index/bruteforce.py``).

``scan_scorer`` is the one scan: the scorer's fused scan + top-k kernel
through :func:`repro_torch.kernels.scorer_topk_prepared`, the port's single
lowering point (its plain version on CPU tensors), with ids in the
scorer's external space. :class:`repro_torch.index.protocol.FlatIndex` is
the same scan behind the Index protocol. The kernels tile the rows
themselves, so the reference's ``block`` argument has no counterpart.

The per-representation entry points move their arrays (numpy or
tensors) to ``device`` (default: the GPU), build the matching scorer and
scan it: ``search`` (``ip_topk``), ``search_quantized`` (``ip_topk`` over u8
codes), ``search_gleanvec`` and ``search_gleanvec_sorted``
(``gleanvec_sq_topk``, gathered and sorted). ``search_gleanvec_sorted``
scans with an IDENTITY permutation, so its ids are rows of the sorted
layout, as the reference's: callers that built the layout with
``gleanvec.sort_by_tag`` translate them through its ``perm``.
"""
from __future__ import annotations

import torch

from repro_torch.core.scorer import (GleanVecScorer, LinearScorer,
                                     QuantizedScorer, SortedGleanVecScorer)
from repro_torch.device import resolve_device

__all__ = ["scan_scorer", "search_scorer", "search", "search_gleanvec",
           "search_gleanvec_sorted", "search_quantized"]


def scan_scorer(scorer, qstate, k: int):
    """Top-k of prepared queries ``qstate`` against every row of
    ``scorer``: (vals (m, k) f32, ids (m, k) int32), ids in the scorer's
    external space, -1 where fewer than k rows are left."""
    from repro_torch.kernels import scorer_topk_prepared
    return scorer_topk_prepared(scorer, qstate, k)


def search_scorer(queries: torch.Tensor, scorer, k: int):
    """Prepare + scan: ``queries (m, D or d)`` -> (vals, ids) (m, k)."""
    return scan_scorer(scorer, scorer.prepare_queries(queries), k)


def _on(device, *arrays, dtypes):
    dev = resolve_device(device)
    return [torch.as_tensor(a, dtype=t, device=dev).contiguous()
            for a, t in zip(arrays, dtypes)]


_F32, _I32 = torch.float32, torch.int32


def search(q_low, x_low, k: int, device=None):
    """Linear path: ``q_low (m, d)`` against ``x_low (n, d)``."""
    q_low, x_low = _on(device, q_low, x_low, dtypes=(_F32, _F32))
    return scan_scorer(LinearScorer(x_low=x_low), q_low, k)


def search_gleanvec(q_views, tags, x_low, k: int, device=None):
    """Eager GleanVec path (Alg. 4): ``q_views (m, C, d)``, ``tags (n,)``,
    ``x_low (n, d)``."""
    q_views, tags, x_low = _on(device, q_views, tags, x_low,
                               dtypes=(_F32, _I32, _F32))
    return scan_scorer(GleanVecScorer(x_low=x_low, tags=tags), q_views, k)


def search_quantized(q_low, codes, lo, delta, k: int, device=None):
    """Int8 scalar-quantized path: ``codes (n, d)`` u8, ``lo`` / ``delta``
    (d,)."""
    q_low, codes, lo, delta = _on(device, q_low, codes, lo, delta,
                                  dtypes=(_F32, torch.uint8, _F32, _F32))
    scorer = QuantizedScorer(codes=codes, lo=lo, delta=delta)
    return scan_scorer(scorer, scorer.prepare_queries(q_low), k)


def search_gleanvec_sorted(q_views, block_tags, x_low, k: int, device=None):
    """Eager GleanVec over a tag-sorted database (``x_low (ns, d)`` whose
    ``ns / len(block_tags)``-row blocks carry one tag each). Ids are rows
    of the sorted layout (an identity permutation; padding rows score as
    zero rows, as in the reference)."""
    q_views, block_tags, x_low = _on(device, q_views, block_tags, x_low,
                                     dtypes=(_F32, _I32, _F32))
    ident = torch.arange(x_low.shape[0], dtype=torch.int32,
                         device=x_low.device)
    scorer = SortedGleanVecScorer(x_low=x_low, block_tags=block_tags,
                                  perm=ident, inv_perm=ident)
    return scan_scorer(scorer, q_views, k)
