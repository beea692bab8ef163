"""The port's hand-written Hopper kernels and its single lowering point.

Each kernel package holds a CUDA C++ kernel (sources in
``repro_torch/csrc``), its plain PyTorch version, a wrapper that takes the
plain version for CPU tensors only and launches the kernel for CUDA
tensors (or raises), and a launch counter (``<wrapper>.launches``).

``scorer_topk`` / ``scorer_topk_prepared`` map each scorer class of
:mod:`repro_torch.core.scorer` to its kernel exactly as the reference's
``repro.kernels.scorer_topk`` does (a live-masked linear or int8 store
through dense scores and ``torch.topk``), ``scorer_scores`` /
``scorer_scores_prepared`` to its dense-score kernel as the reference's
``scorer_scores``, and ``scorer_scan_lists`` lowers the sorted scorers' IVF
fine step (``scan_lists``) to ``ivf_scan_topk``, and
``scorer_scan_neighbors`` their fused graph hop (``scan_neighbors``) to
``graph_scan_beam_step`` and ``scorer_beam_search`` their whole fused
traversal (``beam_search``) to ``graph_beam_search``; index code talks to
scorers, and scorers lower here and nowhere else. ``flash_attention`` is the LM prefill's attention
(called by ``repro_torch.models.attention``).

This module also builds the kernels: ``nvcc`` compiles each source into
its own shared library with a plain C interface (``build``, one compiler
process per source, all started together) under ``build/kernels/`` at the
repository root, at first use, and ``load_library`` loads it with
``ctypes``. Nothing here needs ``nvcc`` or a GPU until a kernel is called
on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path

import torch

from repro_torch.index.topk import NEG_INF
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.gleanvec_ip import gleanvec_ip, gleanvec_ip_plain
from repro_torch.kernels.gleanvec_sq import (bucket_rows_by_tag,
                                             bucket_rows_by_tag_plain,
                                             gleanvec_sq, gleanvec_sq_plain,
                                             gleanvec_sq_topk,
                                             gleanvec_sq_topk_plain)
from repro_torch.kernels.graph_scan import (graph_beam_search,
                                            graph_beam_search_plain,
                                            graph_scan_beam_step,
                                            graph_scan_beam_step_plain,
                                            graph_scan_scores_plain)
from repro_torch.kernels.ip_topk import ip_topk, ip_topk_plain
from repro_torch.kernels.ivf_scan import ivf_scan_topk, ivf_scan_topk_plain
from repro_torch.kernels.kmeans_assign import (kmeans_assign,
                                               kmeans_assign_plain)
from repro_torch.kernels.sq_dot import (sq_dot, sq_dot_folded,
                                        sq_dot_folded_plain)

__all__ = ["ip_topk", "ip_topk_plain", "gleanvec_sq_topk",
           "gleanvec_sq_topk_plain", "kmeans_assign", "kmeans_assign_plain",
           "ivf_scan_topk", "ivf_scan_topk_plain", "sq_dot", "sq_dot_folded",
           "sq_dot_folded_plain", "gleanvec_ip",
           "gleanvec_ip_plain", "gleanvec_sq", "gleanvec_sq_plain",
           "bucket_rows_by_tag", "bucket_rows_by_tag_plain",
           "graph_scan_beam_step", "graph_scan_beam_step_plain",
           "graph_scan_scores_plain", "graph_beam_search",
           "graph_beam_search_plain", "scorer_topk", "scorer_topk_prepared",
           "scorer_scores", "scorer_scores_prepared", "scorer_scan_lists",
           "scorer_scan_neighbors", "scorer_beam_search",
           "gathered_beam_lowering", "flash_attention",
           "flash_attention_plain", "build", "count_launch",
           "load_library", "library_path", "KERNEL_SOURCES", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("ip_topk", "gleanvec_sq", "kmeans_assign", "ivf_scan",
                  "dense_scores", "graph_scan", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

PASS_K = 128            # entries a top-k scan pass keeps per query; a larger
                        # k runs ceil(k / PASS_K) passes (topk_common.cuh)
MERGE_MAX = 8192        # most partial candidates the merge kernel sorts
GEMM_TILE_M = 64        # queries per block of the tiled scan (scan_gemm.cuh)
GEMM_TILE_N = 128       # rows per tile of the tiled scan
IP_TILE_M = 64          # queries per block of ip_topk's pipelined scan
IP_TILE_N = 512         # rows per tile of it (ip_scan.cuh: IP_TM, IP_TN)

_LIBS: dict = {}
# One build-and-load at a time: a serving dispatcher and a refresh worker
# may ask for the same library at once. Re-entrant for a binder that loads.
_LOAD_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "repro_torch/csrc at first use and need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives; the file name carries a digest of
    the sources and flags, so an edited source is rebuilt."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all running at once. Returns {name: seconds} for those built;
    raises with the compiler's output if one fails. Each compiler's log
    (with ``-Xptxas -v``'s registers and shared memory) is kept beside the
    library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log_path = Path(f"{out}.log")
            log = open(log_path, "w")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            jobs[name] = (proc, log, log_path, tmp, out, time.perf_counter())
        seconds = {}
        for name, (proc, log, log_path, tmp, out, t0) in jobs.items():
            proc.wait()
            log.close()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} "
                                   f"(rc {proc.returncode}):\n"
                                   f"{log_path.read_text()[-6000:]}")
            os.replace(tmp, out)
            seconds[name] = time.perf_counter() - t0
        return seconds
    finally:
        for proc, log, *_ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def load_library(name: str, bind=None):
    """The loaded library of kernel source ``name``, built first if needed.
    ``bind(lib)`` declares the argument types of the functions its caller
    uses; each binder runs once per library (one source may serve several
    wrappers, each with its own binder). Thread-safe: concurrent callers
    build and load a library once."""
    with _LOAD_LOCK:
        entry = _LIBS.get(name)
        if entry is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            entry = _LIBS[name] = (lib, set())
        lib, bound = entry
        if bind is not None and bind not in bound:
            bind(lib)
            bound.add(bind)
        return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (under a lock: the serving threads
    launch concurrently)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


# ---------------------------------------------------------------------------
# Wrapper helpers shared by the kernel packages.
# ---------------------------------------------------------------------------


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (take the plain version);
    False when all lie on CUDA; raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs on mixed or unsupported devices: "
                     f"{sorted(kinds)}")


def check_cuda_inputs(name: str, **tensors) -> None:
    """All inputs contiguous and on the current CUDA device."""
    cur = torch.cuda.current_device()
    for arg, t in tensors.items():
        if t.device.index != cur:
            raise ValueError(f"{name}: {arg} is on {t.device}, the current "
                             f"device is cuda:{cur}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"top-k kernels take k >= 1, got {k}")


def pass_k(k: int) -> int:
    """Entries per query of one scan pass's partial lists."""
    return min(k, PASS_K)


def splits(row_tiles: int, query_blocks: int, k: int, blocks_per_sm: int,
           device) -> int:
    """How many blocks share one query block's rows: enough for about four
    waves of resident blocks, no more than there are row tiles, and few
    enough that the merge kernel sorts at most ``MERGE_MAX`` candidates of
    one pass (the dense kernels have no merge and pass ``k=1``)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-4 * sms * blocks_per_sm // max(query_blocks, 1))
    return max(1, min(want, row_tiles, MERGE_MAX // pass_k(k)))


def current_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, err: int, lib) -> None:
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} "
                           f"({msg})")


# ---------------------------------------------------------------------------
# The lowering point: scorer -> kernel.
# ---------------------------------------------------------------------------


def _mask_dead(scores, keep):
    """Dead columns (``keep`` False) to NEG_INF, in place: the (m, n)
    matrix may be the largest tensor of the call."""
    return scores.masked_fill_(~keep[None, :], NEG_INF)


def scorer_scores_prepared(scorer, qstate):
    """Dense (m, n) scores of prepared queries against a scorer's rows,
    lowered as the reference's ``repro.kernels.scorer_scores``:

    * ``LinearScorer`` -> ``q_low @ x_low.T`` (a plain matmul there too);
    * ``QuantizedScorer`` -> ``sq_dot`` (its prepared state is the fold);
    * ``GleanVecScorer`` -> ``gleanvec_ip``;
    * ``GleanVecQuantizedScorer`` and both sorted layouts -> dense
      ``gleanvec_sq``; the sorted ones set padding (``perm < 0``) to
      NEG_INF.

    Column j is row j of the scorer's storage: the original id for the
    row-aligned scorers, sorted row j for the sorted ones. Dead slots of a
    ``live`` mask are set to NEG_INF after the kernel."""
    from repro_torch.core import scorer as sc

    live = getattr(scorer, "live", None)
    if isinstance(scorer, sc.LinearScorer):
        scores = qstate @ scorer.x_low.T
    elif isinstance(scorer, sc.QuantizedScorer):
        scores = sq_dot_folded(qstate.q_scaled, qstate.q_lo, scorer.codes)
    elif isinstance(scorer, sc.GleanVecScorer):
        scores = gleanvec_ip(qstate, scorer.tags, scorer.x_low)
    elif isinstance(scorer, sc.GleanVecQuantizedScorer):
        scores = gleanvec_sq(qstate.q_scaled, qstate.q_lo, scorer.tags,
                             scorer.codes)
    elif isinstance(scorer, sc.SortedGleanVecScorer):
        q_lo = torch.zeros(qstate.shape[:2], dtype=torch.float32,
                           device=qstate.device)        # no affine term
        scores = gleanvec_sq(qstate, q_lo, scorer.block_tags, scorer.x_low,
                             layout_block=scorer.layout_block)
        return _mask_dead(scores, scorer.perm >= 0)
    elif isinstance(scorer, sc.SortedGleanVecQuantizedScorer):
        scores = gleanvec_sq(qstate.q_scaled, qstate.q_lo, scorer.block_tags,
                             scorer.codes, layout_block=scorer.layout_block)
        return _mask_dead(scores, scorer.perm >= 0)
    else:
        raise TypeError(f"no kernel lowering for {type(scorer).__name__}")
    return scores if live is None else _mask_dead(scores, live)


def scorer_scores(scorer, queries):
    """Prepare ``queries (m, D)`` with the scorer, then
    :func:`scorer_scores_prepared`."""
    return scorer_scores_prepared(scorer, scorer.prepare_queries(queries))


def scorer_topk_prepared(scorer, qstate, k: int):
    """Fused top-k of an already-prepared query state against a scorer's
    database. Returns (vals (m, k) f32, ids (m, k) i32), ids in the
    ORIGINAL database space (the sorted scorers pass their permutation to
    the kernel as ``row_ids``), -1 where no live row is left. Mirrors
    ``repro.kernels.scorer_topk``:

    * ``LinearScorer`` -> ``ip_topk``;
    * ``QuantizedScorer`` -> ``ip_topk`` over the u8 codes, with the
      query-constant offset <Aq, lo> added to the values outside;
    * either of the two with a ``live`` mask -> dense scores
      (:func:`scorer_scores_prepared`: a matmul, or ``sq_dot``) and
      ``torch.topk``; dead winners translate to -1 (the reference's
      serving scan does this through ``translate_ids``);
    * the GleanVec family (eager, int8, both sorted layouts) ->
      ``gleanvec_sq_topk``; a ``live`` mask enters as ``row_ids`` (-1 on
      dead rows).
    """
    from repro_torch.core import scorer as sc

    live = getattr(scorer, "live", None)
    live_ids = None
    if live is not None:
        if isinstance(scorer, (sc.LinearScorer, sc.QuantizedScorer)):
            scores = scorer_scores_prepared(scorer, qstate)
            vals, idx = torch.topk(scores, min(k, scores.shape[1]), dim=1)
            del scores
            if vals.shape[1] < k:           # fewer rows than k
                pad = k - vals.shape[1]
                vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
                idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
            return vals, scorer.translate_ids(idx.to(torch.int32))
        live_ids = torch.where(
            live, torch.arange(live.shape[0], dtype=torch.int32,
                               device=live.device),
            torch.full_like(live, -1, dtype=torch.int32))
    if isinstance(scorer, sc.LinearScorer):
        return ip_topk(qstate, scorer.x_low, k)
    if isinstance(scorer, sc.QuantizedScorer):
        vals, ids = ip_topk(qstate.q_scaled, scorer.codes, k)
        return vals + qstate.q_lo[:, None], ids
    if isinstance(scorer, sc.GleanVecScorer):
        q_lo = torch.zeros(qstate.shape[:2], dtype=torch.float32,
                           device=qstate.device)        # no affine term
        return gleanvec_sq_topk(qstate, q_lo, scorer.tags, scorer.x_low, k,
                                row_ids=live_ids)
    if isinstance(scorer, sc.GleanVecQuantizedScorer):
        return gleanvec_sq_topk(qstate.q_scaled, qstate.q_lo, scorer.tags,
                                scorer.codes, k, row_ids=live_ids)
    if isinstance(scorer, sc.SortedGleanVecScorer):
        q_lo = torch.zeros(qstate.shape[:2], dtype=torch.float32,
                           device=qstate.device)        # no affine term
        return gleanvec_sq_topk(qstate, q_lo, scorer.block_tags,
                                scorer.x_low, k, row_ids=scorer.perm,
                                layout_block=scorer.layout_block)
    if isinstance(scorer, sc.SortedGleanVecQuantizedScorer):
        return gleanvec_sq_topk(qstate.q_scaled, qstate.q_lo,
                                scorer.block_tags, scorer.codes, k,
                                row_ids=scorer.perm,
                                layout_block=scorer.layout_block)
    raise TypeError(f"no kernel lowering for {type(scorer).__name__}")


def scorer_topk(scorer, queries, k: int):
    """Prepare ``queries (m, D)`` with the scorer, then
    :func:`scorer_topk_prepared`."""
    return scorer_topk_prepared(scorer, scorer.prepare_queries(queries), k)


def scorer_scan_lists(scorer, qstate, probe, k: int):
    """Gather-free IVF fine step of a sorted scorer: the probe schedule
    ``list_block_ranges[probe]`` (m, nprobe * max_blocks) through
    ``ivf_scan_topk`` with the scorer's layout. Mirrors the reference's
    ``Sorted*Scorer.scan_lists``: (vals (m, k) f32, ids (m, k) i32),
    ORIGINAL ids, -1 for -inf winners."""
    from repro_torch.core import scorer as sc

    if not isinstance(scorer, (sc.SortedGleanVecScorer,
                               sc.SortedGleanVecQuantizedScorer)):
        raise TypeError(f"no scan_lists lowering for {type(scorer).__name__}")
    if scorer.list_block_ranges is None:
        raise ValueError("scan_lists needs list_block_ranges; build the "
                         "scorer through its factory")
    m = probe.shape[0]
    sched = scorer.list_block_ranges[probe.long()].reshape(m, -1)
    if isinstance(scorer, sc.SortedGleanVecScorer):
        q_lo = torch.zeros(qstate.shape[:2], dtype=torch.float32,
                           device=qstate.device)        # no affine term
        return ivf_scan_topk(qstate, q_lo, scorer.block_tags, scorer.perm,
                             scorer.x_low, sched, k,
                             layout_block=scorer.layout_block)
    return ivf_scan_topk(qstate.q_scaled, qstate.q_lo, scorer.block_tags,
                         scorer.perm, scorer.codes, sched, k,
                         layout_block=scorer.layout_block)


def scorer_scan_neighbors(scorer, qstate, nbr_rows, beam_vals, beam_ids,
                          tn: int = 8):
    """Gather-free graph hop of a sorted scorer: the neighbor SORTED rows
    ``nbr_rows (m, S)`` (-1 = pad) folded into the beam ``(beam_vals,
    beam_ids) (m, B)`` by ``graph_scan_beam_step`` with the scorer's
    layout. Mirrors the reference's ``Sorted*Scorer.scan_neighbors``: the
    merged (vals, ids) (m, B), ids ORIGINAL (best first here; the
    reference's TPU kernel leaves them in slot order)."""
    from repro_torch.core import scorer as sc

    if isinstance(scorer, sc.SortedGleanVecScorer):
        q_lo = torch.zeros(qstate.shape[:2], dtype=torch.float32,
                           device=qstate.device)        # no affine term
        return graph_scan_beam_step(qstate, q_lo, scorer.block_tags,
                                    scorer.perm, scorer.x_low, nbr_rows,
                                    beam_vals, beam_ids,
                                    layout_block=scorer.layout_block, tn=tn)
    if isinstance(scorer, sc.SortedGleanVecQuantizedScorer):
        return graph_scan_beam_step(qstate.q_scaled, qstate.q_lo,
                                    scorer.block_tags, scorer.perm,
                                    scorer.codes, nbr_rows, beam_vals,
                                    beam_ids,
                                    layout_block=scorer.layout_block, tn=tn)
    raise TypeError(f"no scan_neighbors lowering for "
                    f"{type(scorer).__name__}")


# id(rows) -> (weak references to (rows, tags, live), (block_tags, row_ids)):
# one entry a store tensor, replaced when a scorer over the same rows
# brings new tags or a new live mask, dropped when the rows die
_GATHERED_LAYOUTS: dict = {}


def _gathered_layout(rows, tags, live):
    """``(block_tags, row_ids)`` of a gathered store as
    ``graph_beam_search`` reads it at layout block 1: each row's tag (int32;
    zeros for a one-view store) and each row's id, which is the row itself
    (-1 where ``live`` marks the row removed). Made once for a scorer's
    tensors: the scorers are immutable (every update makes new tensors),
    so the batches of one scorer reuse it. Only the newest layout of a
    store tensor is kept (a stream of removes keeps the codes and makes a
    new live mask each time)."""
    key = id(rows)
    hit = _GATHERED_LAYOUTS.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0],
                                                        (rows, tags, live))):
        return hit[1]
    n, dev = rows.shape[0], rows.device
    block_tags = (torch.zeros((n,), dtype=torch.int32, device=dev)
                  if tags is None else tags.to(torch.int32).contiguous())
    row_ids = torch.arange(n, dtype=torch.int32, device=dev)
    if live is not None:
        row_ids = torch.where(live, row_ids, torch.full_like(row_ids, -1))
    refs = tuple((lambda: None) if t is None else weakref.ref(t)
                 for t in (rows, tags, live))
    if hit is None or hit[0][0]() is not rows:
        weakref.finalize(rows, _GATHERED_LAYOUTS.pop, key, None)
    _GATHERED_LAYOUTS[key] = (refs, (block_tags, row_ids))
    return block_tags, row_ids


def gathered_beam_lowering(scorer) -> bool:
    """True for the four gathered scorer classes, whose whole graph
    traversal :func:`scorer_beam_search` lowers over the graph's id table
    (rows are ids)."""
    from repro_torch.core import scorer as sc
    return isinstance(scorer, (sc.LinearScorer, sc.QuantizedScorer,
                               sc.GleanVecScorer,
                               sc.GleanVecQuantizedScorer))


def scorer_beam_search(scorer, qstate, nbr_tbl, beam_vals, beam_ids,
                       max_hops: int, expand: int):
    """The whole graph traversal in one ``graph_beam_search`` launch: from
    the scored entry beam ``(beam_vals, beam_ids) (m, B)`` (slot order),
    hops through ``nbr_tbl (n, R)`` with the scorer's layout, each hop the
    one :func:`scorer_scan_neighbors` lowers. Returns (vals, ids) (m, B),
    ids ORIGINAL and best first, and each query's hop count (m,) i32, on
    the device.

    A tag-sorted scorer reads a fused graph's sorted-row table
    (``GraphIndex.nbr_rows``). A gathered scorer reads the graph's id table
    (``GraphIndex.neighbors``) as rows of its own store at layout block 1:
    codes ``x_low`` or the u8 codes, its per-row tags (zeros with one
    view), ``row_ids`` the rows themselves (-1 for a removed row), and its
    query state as ``q_scaled (m, C, d)`` / ``q_lo (m, C)`` (zeros where
    the mode has no affine term)."""
    from repro_torch.core import scorer as sc

    if isinstance(scorer, sc.SortedGleanVecScorer):
        q_lo = torch.zeros(qstate.shape[:2], dtype=torch.float32,
                           device=qstate.device)        # no affine term
        return graph_beam_search(qstate, q_lo, scorer.block_tags,
                                 scorer.perm, scorer.x_low, nbr_tbl,
                                 beam_vals, beam_ids,
                                 layout_block=scorer.layout_block,
                                 max_hops=max_hops, expand=expand)
    if isinstance(scorer, sc.SortedGleanVecQuantizedScorer):
        return graph_beam_search(qstate.q_scaled, qstate.q_lo,
                                 scorer.block_tags, scorer.perm,
                                 scorer.codes, nbr_tbl, beam_vals, beam_ids,
                                 layout_block=scorer.layout_block,
                                 max_hops=max_hops, expand=expand)
    if not gathered_beam_lowering(scorer):
        raise TypeError(f"no beam_search lowering for "
                        f"{type(scorer).__name__}")
    quant = isinstance(qstate, sc.QuantQueryState)
    q = qstate.q_scaled if quant else qstate
    rows = getattr(scorer, "codes", None)
    rows = scorer.x_low if rows is None else rows
    tags = getattr(scorer, "tags", None)
    if q.ndim == 2:                                      # one view: C = 1
        q = q[:, None, :]
    if quant:
        q_lo = qstate.q_lo
        q_lo = q_lo[:, None] if q_lo.ndim == 1 else q_lo
    else:
        q_lo = torch.zeros(q.shape[:2], dtype=torch.float32,
                           device=q.device)              # no affine term
    block_tags, row_ids = _gathered_layout(rows, tags, scorer.live)
    return graph_beam_search(q.contiguous(), q_lo.contiguous(), block_tags,
                             row_ids, rows.contiguous(), nbr_tbl, beam_vals,
                             beam_ids, layout_block=1, max_hops=max_hops,
                             expand=expand)
