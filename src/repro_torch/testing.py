"""Top-k parity checks shared by the tests and ``chip_smoke.py``.

Two top-k results of the same scan agree when, per query:

* their sorted value lists agree within ``tol``;
* an id on both sides carries the same value on both, within ``tol`` (so
  right ids paired with the wrong values fail); and
* every id on one side is on the other side too, except where its value is
  within ``tol`` of the other side's k-th value -- a near-tie at the
  cut-off that a different summation order may resolve either way.

``dot_tol`` states the tolerance of two fp32 dot products that add the
same terms in a different order; ``attention_error`` compares two
evaluations of one attention output; ``exact_sorted_topk`` is the exact
top-k of the tag-sorted GleanVec layout on integer data, which an fp32
kernel must match bit for bit; ``ivf_schedule_case`` makes the inputs of
``ivf_scan_topk`` for each kind of probe schedule the kernel must take,
and ``exact_ivf_topk`` their exact top-k. ``sharded_as_one`` folds the
per-shard int8 scorers of a sharded placement into one row-aligned scorer
whose single-device scan scores every row as its shard does;
``merged_shards`` merges per-shard results by hand and
``row_shards_merged`` runs a globally built scorer's row shards one by one,
the checks of a sharded placement that do not go through its own merge.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dot_tol", "topk_agreement", "assert_topk_close",
           "attention_abs_mix", "attention_error", "exact_sorted_topk",
           "IVF_SCHEDULES", "ivf_schedule_case", "exact_ivf_topk",
           "sharded_as_one", "merged_shards", "row_shards_merged"]

EPS32 = 2.0 ** -24


def dot_tol(q_norm_max: float, x_norm_max: float, d: int,
            offset_max: float = 0.0) -> float:
    """Bound on the gap between two fp32 evaluations of <q, x> (+ an
    offset) of length ``d`` summed in different orders: each evaluation
    is within d * eps * |q| |x| of the exact sum (Cauchy-Schwarz bounds
    sum |q_j x_j|), plus a rounding of the offset."""
    return 2.0 * d * EPS32 * q_norm_max * x_norm_max \
        + 4.0 * EPS32 * abs(offset_max)


def attention_abs_mix(q, k, v, causal: bool = True, window=None):
    """Each output element's ``sum_j p_j |v_j|`` in f32: the attention of
    ``q``, ``k`` (the plain version's weights) applied to ``|v|``. It
    scales :func:`attention_error`'s tolerance element by element."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    return flash_attention_plain(q.to(torch.float32), k.to(torch.float32),
                                 v.to(torch.float32).abs(), causal, window)


def attention_error(got, want, abs_mix):
    """``(max_abs_err, used)`` of two evaluations of one attention output
    in ``want``'s type, computed on ``want``'s device: the largest
    ``|got - want|`` and the largest share of its tolerance that an
    element's gap takes (<= 1: they agree; inf if ``got`` is not finite).
    ``abs_mix`` is
    :func:`attention_abs_mix` of the same inputs: an output element is
    ``sum_j p_j v_j``, so a relative error e in the weights moves it by at
    most ``e * abs_mix``. Per element:

    * f32: 1e-4 (|want| + abs_mix) -- the softmax and both products in
      f32, summed in another order;
    * bf16: that, plus 2^-7 |want| (the two outputs each rounded to bf16,
      2^-8 relative each) plus 2^-8 abs_mix (the weights rounded to bf16
      for the tensor cores, 2^-8 relative each).
    """
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} vs "
                         f"{tuple(want.shape)}")
    if want.numel() == 0:
        return 0.0, 0.0
    g = got.detach().to(want.device, torch.float32)
    w = want.detach().to(torch.float32)
    if not bool(torch.isfinite(g).all()):
        return float("inf"), float("inf")
    a = abs_mix.detach().to(want.device, torch.float32)
    tol = 1e-4 * (w.abs() + a)
    if want.dtype == torch.bfloat16:
        tol += 2.0 ** -7 * w.abs() + 2.0 ** -8 * a
    gap = (g - w).abs()
    used = torch.where(gap > 0, gap / tol, torch.zeros_like(gap))
    return float(gap.max()), float(used.max())


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def topk_agreement(res_a, res_b, tol: float) -> dict:
    """Compare two ``(vals (m, k), ids (m, k))`` results. Returns
    ``{"ok", "max_abs_err", "max_rel_err", "id_agreement", "bad_rows"}``:
    the largest gap between the sorted value lists, that gap over the
    largest |value|, the mean fraction of shared ids, and the rows that
    break the rule above."""
    va, ia = (_np(x) for x in res_a)
    vb, ib = (_np(x) for x in res_b)
    if va.shape != vb.shape or ia.shape != ib.shape:
        raise ValueError(f"shapes differ: {va.shape} vs {vb.shape}")
    va = va.astype(np.float64)
    vb = vb.astype(np.float64)
    sa = -np.sort(-va, axis=1)
    sb = -np.sort(-vb, axis=1)
    gap = np.abs(sa - sb)
    max_abs = float(gap.max()) if gap.size else 0.0
    finite = np.abs(np.concatenate([va.ravel(), vb.ravel()]))
    finite = finite[finite < 1e37]
    scale = float(finite.max()) if finite.size else 1.0
    bad_rows, shared = [], []
    for r in range(ia.shape[0]):
        a_ids, b_ids = set(ia[r].tolist()), set(ib[r].tolist())
        shared.append(len(a_ids & b_ids) / max(len(a_ids), 1))
        ok = bool(gap[r].max() <= tol) if gap.shape[1] else True
        kth_a, kth_b = sa[r, -1], sb[r, -1]
        b_val = dict(zip(ib[r].tolist(), vb[r].tolist()))
        for j in range(ia.shape[1]):
            if ia[r, j] in b_ids:
                if abs(va[r, j] - b_val[ia[r, j]]) > tol:
                    ok = False
            elif abs(va[r, j] - kth_b) > tol:
                ok = False
            if ib[r, j] not in a_ids and abs(vb[r, j] - kth_a) > tol:
                ok = False
        if not ok:
            bad_rows.append(r)
    return {"ok": not bad_rows, "max_abs_err": max_abs,
            "max_rel_err": max_abs / max(scale, 1e-30),
            "id_agreement": float(np.mean(shared)) if shared else 1.0,
            "bad_rows": bad_rows}


def assert_topk_close(res_a, res_b, tol: float, label: str = "") -> dict:
    """:func:`topk_agreement`, raising ``AssertionError`` with the first
    offending rows when the results disagree."""
    rep = topk_agreement(res_a, res_b, tol)
    if not rep["ok"]:
        va, ia = (_np(x) for x in res_a)
        vb, ib = (_np(x) for x in res_b)
        r = rep["bad_rows"][0]
        raise AssertionError(
            f"{label}: top-k disagree beyond tol={tol:.3g} in "
            f"{len(rep['bad_rows'])} rows; first row {r}:\n"
            f"  a ids {ia[r].tolist()}\n  a vals {va[r].tolist()}\n"
            f"  b ids {ib[r].tolist()}\n  b vals {vb[r].tolist()}")
    return rep


def exact_sorted_topk(q_scaled, q_lo, block_tags, codes, row_ids, k: int,
                      layout_block: int):
    """The top-k of ``<q_scaled[m, tag_n], codes_n> + q_lo[m, tag_n]`` (tag_n
    = ``block_tags[n // layout_block]``) scored in float64: exact for
    small-integer data, where every fp32 evaluation is exact too. Value
    descending, ties to the smaller id, rows with ``row_ids`` -1 left out;
    (-3.4e38, -1) past the live rows. -> (vals (M, k) f32, ids (M, k)
    i32)."""
    n = codes.shape[0]
    dev = codes.device
    tag = block_tags.long()[torch.arange(n, device=dev) // layout_block]
    s = torch.empty((q_scaled.shape[0], n), dtype=torch.float64, device=dev)
    for t in torch.unique(tag).tolist():      # one matmul a view
        rows = torch.nonzero(tag == t).squeeze(1)
        s[:, rows] = q_scaled[:, t].double() @ codes[rows].double().T \
            + q_lo[:, t:t + 1].double()
    live = row_ids >= 0
    s, ids = s[:, live], row_ids[live].long()
    order = torch.argsort(ids)
    s, ids = s[:, order], ids[order]        # ascending ids, then a stable sort
    vals, sel = torch.sort(s, dim=1, descending=True, stable=True)
    kk = min(k, ids.numel())
    m = q_scaled.shape[0]
    v = torch.full((m, k), -3.4e38, dtype=torch.float32, device=dev)
    i = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    v[:, :kk] = vals[:, :kk].float()
    i[:, :kk] = ids[sel[:, :kk]].int()
    return v, i


# The kinds of probe schedule ``ivf_scan_topk`` must take (its runs:
# ``kernels.ivf_scan.schedule_runs``): whole lists (the main path), a pad
# slot inside a list, blocks in random order, consecutive blocks across a
# tag change, a list and a block listed twice, all pad, no queries, and a
# streaming layout of 256-row blocks whose lists end in slack blocks.
IVF_SCHEDULES = ("contiguous", "pad_inside", "non_contiguous", "tag_change",
                 "duplicate", "all_pad", "no_queries", "slack_256")


def ivf_schedule_case(kind: str, u8: bool, seed: int = 0,
                      integer: bool = False, m: int = 6, c: int = 4,
                      d: int = 8, layout_block: int = 32):
    """numpy inputs ``(q_scaled, q_lo, block_tags, row_ids, codes, sched,
    layout_block)`` of ``ivf_scan_topk`` for one of ``IVF_SCHEDULES``, made
    from ``seed``: a tag-sorted layout (clusters of 1 to 4 layout blocks in
    tag order; ``slack_256``: blocks of 256 rows and one all-padding slack
    block a cluster), ~15 % padding rows, and each query's schedule built
    from the clusters' block ranges as the IVF builds it (two probed lists,
    each padded with -1 to the longest list). ``integer``: small integers
    everywhere, so every fp32 evaluation is exact."""
    if kind not in IVF_SCHEDULES:
        raise ValueError(f"unknown schedule kind {kind!r}")
    rng = np.random.default_rng(seed * 131 + IVF_SCHEDULES.index(kind))
    slack = kind == "slack_256"
    lb = 256 if slack else layout_block
    if kind == "no_queries":
        m = 0
    sizes = rng.integers(1, 5, c)
    sizes[rng.integers(c)] = 4                     # one list of 4 blocks
    sizes = sizes + (1 if slack else 0)
    tags = np.repeat(np.arange(c), sizes).astype(np.int32)
    nb = tags.size
    n = nb * lb
    row_ids = rng.permutation(n).astype(np.int32)
    row_ids[rng.random(n) < 0.15] = -1
    ends = np.cumsum(sizes)
    if slack:
        for e in ends:
            row_ids[(e - 1) * lb:e * lb] = -1      # the slack blocks
    if integer:
        q_scaled = rng.integers(-3, 4, (m, c, d)).astype(np.float32)
        q_lo = rng.integers(-8, 9, (m, c)).astype(np.float32)
        codes = rng.integers(0, 9, (n, d)) if u8 \
            else rng.integers(-4, 5, (n, d))
    else:
        q_scaled = rng.standard_normal((m, c, d)).astype(np.float32)
        q_lo = rng.standard_normal((m, c)).astype(np.float32)
        codes = rng.integers(0, 256, (n, d)) if u8 \
            else rng.standard_normal((n, d))
    codes = codes.astype(np.uint8 if u8 else np.float32)
    maxb = int(sizes.max())
    ranges = np.full((c, maxb), -1, np.int32)
    for t in range(c):
        ranges[t, :sizes[t]] = np.arange(ends[t] - sizes[t], ends[t])
    probe = np.array([rng.permutation(c)[:2] for _ in range(m)],
                     dtype=np.int64).reshape(m, 2)
    if kind == "pad_inside":
        probe[:, 0] = int(np.argmax(sizes))        # a list of >= 3 blocks
    sched = ranges[probe].reshape(m, 2 * maxb)
    if kind == "pad_inside":
        sched[:, 1] = -1
    elif kind == "non_contiguous":
        sched = np.full((m, 2 * maxb), -1)
        for q in range(m):
            blocks = rng.permutation(nb)[:2 * maxb]
            sched[q, :blocks.size] = blocks
        sched[:, maxb // 2] = -1
    elif kind == "tag_change":
        win = min(2 * maxb, nb)
        start = rng.integers(0, nb - win + 1, m)
        sched = np.full((m, 2 * maxb), -1)
        sched[:, :win] = start[:, None] + np.arange(win)[None, :]
    elif kind == "duplicate":
        sched = np.concatenate([ranges[probe[:, 0]], ranges[probe[:, 0]],
                                np.repeat(ranges[probe[:, 1], :1], 2, 1)],
                               axis=1)
    elif kind == "all_pad":
        sched = np.full_like(sched, -1)
    if m > 1 and kind != "all_pad":
        sched[1] = -1                              # an all-pad query
    return (q_scaled, q_lo, tags, row_ids, codes,
            np.ascontiguousarray(sched, dtype=np.int32), lb)


def exact_ivf_topk(q_scaled, q_lo, block_tags, row_ids, codes, sched,
                   k: int, layout_block: int):
    """The exact top-k of each query over its scheduled blocks' rows (pad
    slots and blocks outside the layout left out; a block listed twice
    counted twice), scored in float64 by :func:`exact_sorted_topk` over
    the query's own gathered layout: on integer data an fp32 kernel must
    match it bit for bit. Tensors in, (vals (M, k) f32, ids (M, k) i32)
    on their device out."""
    nb = block_tags.shape[0]
    m = sched.shape[0]
    dev = codes.device
    vals = torch.full((m, k), -3.4e38, dtype=torch.float32, device=dev)
    ids = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    for q in range(m):
        blocks = [b for b in sched[q].tolist() if 0 <= b < nb]
        if not blocks:
            continue
        rows = torch.cat([torch.arange(b * layout_block,
                                       min((b + 1) * layout_block,
                                           codes.shape[0]), device=dev)
                          for b in blocks])
        tags = torch.cat([block_tags[b:b + 1].expand(
            min(layout_block, codes.shape[0] - b * layout_block))
            for b in blocks])
        v, i = exact_sorted_topk(q_scaled[q:q + 1], q_lo[q:q + 1], tags,
                                 codes[rows], row_ids[rows], k, 1)
        vals[q], ids[q] = v[0], i[0]
    return vals, ids


def sharded_as_one(stacked):
    """One :class:`~repro_torch.core.scorer.GleanVecQuantizedScorer` over
    all rows of a stacked per-shard int8 scorer (``QuantizedScorer``,
    ``GleanVecQuantizedScorer`` or ``SortedGleanVecQuantizedScorer``
    stacks): shard s's cluster c becomes cluster ``s C + c`` with that
    shard's view, ``lo`` and ``delta`` (a linear scorer's shard is one
    cluster), rows in global order. Its single-device scan (the gathered
    ``gleanvec_sq_topk``) scores every row as its own shard's scorer does,
    so its top-k is the exact merge a sharded search must return -- an
    independent check of a placement whose shards fit their own int8
    scales, which a scan of one globally fitted scorer cannot be."""
    from repro_torch.core import scorer as sc
    from repro_torch.index.distributed import _take_shard
    n_shards = stacked[0].shape[0]
    codes, tags, lo, delta, a = [], [], [], [], []
    offset = 0
    for s in range(n_shards):
        one = _take_shard(stacked, s)
        if isinstance(one, sc.QuantizedScorer):
            c_rows = one.codes
            t_rows = torch.zeros(c_rows.shape[0], dtype=torch.int64,
                                 device=c_rows.device)
            one_lo, one_delta, one_a = one.lo[None], one.delta[None], \
                one.a[None]
        elif isinstance(one, sc.GleanVecQuantizedScorer):
            c_rows, t_rows = one.codes, one.tags.to(torch.int64)
            one_lo, one_delta, one_a = one.lo, one.delta, one.a
        elif isinstance(one, sc.SortedGleanVecQuantizedScorer):
            rows = one.inv_perm.to(torch.int64)    # local id -> sorted row
            c_rows = one.codes[rows]
            t_rows = one.block_tags[rows // one.layout_block].to(torch.int64)
            one_lo, one_delta, one_a = one.lo, one.delta, one.a
        else:
            raise TypeError(f"no int8 fold for {type(one).__name__}")
        codes.append(c_rows)
        tags.append(t_rows + offset)
        lo.append(one_lo)
        delta.append(one_delta)
        a.append(one_a)
        offset += one_lo.shape[0]
    return sc.GleanVecQuantizedScorer(
        codes=torch.cat(codes), tags=torch.cat(tags).to(torch.int32),
        lo=torch.cat(lo), delta=torch.cat(delta), a=torch.cat(a))


def merged_shards(parts, k: int):
    """The global top ``k`` of per-shard ``(vals, ids)`` results whose ids
    are already global, merged by hand: shard after shard, one stable
    descending sort (equal values to the earlier shard)."""
    vals = torch.cat([v for v, _ in parts], dim=1)
    ids = torch.cat([i for _, i in parts], dim=1)
    order = torch.argsort(vals, dim=1, descending=True, stable=True)[:, :k]
    return torch.gather(vals, 1, order), torch.gather(ids, 1, order)


def row_shards_merged(queries, scorer, n_shards: int, k: int):
    """A globally built scorer cut into ``n_shards`` row shards
    (``scorer.shard_rows``), each scanned alone by the flat index, its ids
    lifted by the scorer-level ``globalize_ids(ids, shard)``, then
    :func:`merged_shards`: what a process group of ``n_shards`` ranks
    returns, on one device."""
    from repro_torch.index.protocol import FlatIndex
    flat, parts = FlatIndex(), []
    for s in range(n_shards):
        rows = scorer.shard_rows(s, n_shards)
        vals, ids = flat.search(queries, rows, k)
        parts.append((vals, rows.globalize_ids(ids, s)))
    return merged_shards(parts, k)
