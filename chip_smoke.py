#!/usr/bin/env python3
"""Drive the PyTorch port's flat-index search path on one NVIDIA GPU.

    python3 chip_smoke.py                  # the whole check
    python3 chip_smoke.py --kernels-only   # build + phase 2 only

Phases (any failure raises and the script exits non-zero):

1. Card and build: print the card, turn TF32 off, build the CUDA kernels
   from ``src/repro_torch/csrc`` (one nvcc per source, in parallel).
2. Kernels against their plain PyTorch versions at ragged shapes: M and N
   off the tiles, k in {10, 100}, u8 and f32 codes, row_ids with -1,
   gathered and sorted layouts, exact ties.
3. The main path: synthetic OOD data (D = 512), LeanVec-Sphering
   (d = 160) and GleanVec (C = 48, d = 160) fits, then for each of the 7
   scorer modes an encoded scorer behind a ServingEngine (batch 1024,
   k = 10, kappa = 100; kappa = 10 for ``full``) answering 5 batches, with
   QPS, p50, p99 and recall@10 against the mode's floor. Launch counters
   are zeroed just before and read just after.
4. Each kernel at the main path's shapes and inputs: its time beside its
   bound, its plain version's time and, where one fits in memory, the
   time of the composed PyTorch calls that compute the same function
   (``library_ms``); and its agreement with the plain version.

Then the card's name and power limit, one JSON line with the kernel table,
and the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package. Needs a CUDA
device and the repository's ``src/repro_torch`` beside this file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM rates (NVIDIA data sheet) used for the bounds: fp32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Database rows of the main path: the paper's OI-13M widths with the
# database cut from 13M (PERF.md, "Cells").
N_ROWS = 2_000_000

# recall@10 floors of the main path (PERF.md, "Recall floors"): the JAX
# reference's own recall on the CPU at the same widths and smaller n, less
# the mode's own measured drop per decade of n and a 0.05 margin.
RECALL_FLOORS = {
    "full": 0.999,
    "sphering": 0.95,
    "gleanvec": 0.95,
    "sphering-int8": 0.126,
    "gleanvec-int8": 0.95,
    "gleanvec-sorted": 0.95,
    "gleanvec-int8-sorted": 0.95,
}

KERNEL_FILES = {
    "ip_topk": ("src/repro_torch/csrc/ip_topk.cu",
                "src/repro/kernels/ip_topk/ip_topk.py:94"),
    "gleanvec_sq_topk": ("src/repro_torch/csrc/gleanvec_sq.cu",
                         "src/repro/kernels/gleanvec_sq/gleanvec_sq.py:226"),
    "kmeans_assign": ("src/repro_torch/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kmeans_assign.py:43"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int):
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back runs after one
    warm-up, from CUDA events; returns (ms, last result)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def timed_once(fn):
    """Milliseconds of a single run of ``fn`` (no warm-up)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def row_norm_max(x: torch.Tensor) -> float:
    x = x.reshape(-1, x.shape[-1])
    best = 0.0
    for s in range(0, x.shape[0], 1 << 20):
        best = max(best, float(torch.linalg.norm(
            x[s:s + (1 << 20)].to(torch.float32), dim=1).max()))
    return best


# ---------------------------------------------------------------------------
# Phase 2: kernels against plain versions at ragged shapes.
# ---------------------------------------------------------------------------


def check_topk(label, kernel_out, plain_out, tol, testing):
    rep = testing.assert_topk_close(kernel_out, plain_out, tol, label)
    log(f"  {label}: max_abs_err={rep['max_abs_err']:.3e} "
        f"max_rel_err={rep['max_rel_err']:.3e} "
        f"id_agreement={rep['id_agreement']:.4f} tol={tol:.3e}")
    return rep


def check_kmeans(label, x, centers, kernel_out, plain_out, testing):
    """Max similarities agree within the fp32 reordering bound; a tag may
    differ only where the plain version scores the kernel's center within
    that bound of its own maximum (a near-tie)."""
    tags_k, sims_k = kernel_out
    tags_p, sims_p = plain_out
    tol = testing.dot_tol(row_norm_max(x), row_norm_max(centers),
                          x.shape[1])
    err = float((sims_k - sims_p).abs().max())
    diff = torch.nonzero(tags_k != tags_p).squeeze(1)
    if diff.numel():
        alt = (x[diff].to(torch.float32)
               * centers[tags_k[diff].long()]).sum(dim=1)
        worst = float((sims_p[diff] - alt).abs().max())
    else:
        worst = 0.0
    agree = 1.0 - diff.numel() / max(1, tags_k.numel())
    log(f"  {label}: max_abs_err={err:.3e} tag_agreement={agree:.6f} "
        f"worst_tag_gap={worst:.3e} tol={tol:.3e}")
    if err > tol or worst > tol:
        raise AssertionError(f"{label}: kmeans_assign disagrees with its "
                             f"plain version beyond tol={tol:.3e}")
    return err


def phase_kernels(K, testing, gen):
    log("phase 2: kernels against plain versions at ragged shapes "
        "(tolerance: fp32 sums in another order, testing.dot_tol)")
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def codes(n, d, u8):
        if u8:
            return torch.randint(0, 256, (n, d), generator=gen, device=dev,
                                 dtype=torch.uint8)
        return randn(n, d)

    for m, n, d, k, u8 in [(37, 5003, 160, 10, False),
                           (37, 5003, 160, 100, True),
                           (130, 20011, 512, 10, False),
                           (3, 50, 20, 100, False)]:
        q, x = randn(m, d), codes(n, d, u8)
        tol = testing.dot_tol(row_norm_max(q), row_norm_max(x), d)
        check_topk(f"ip_topk M={m} N={n} d={d} k={k} "
                   f"{'u8' if u8 else 'f32'}", K.ip_topk(q, x, k),
                   K.ip_topk_plain(q, x, k), tol, testing)

    for m, c, d, n, k, u8, masked in [(9, 48, 160, 7001, 100, True, True),
                                      (6, 5, 33, 3000, 10, False, False),
                                      (70, 8, 64, 2000, 100, False, True)]:
        qs, qlo = randn(m, c, d), randn(m, c)
        x = codes(n, d, u8)
        tags = torch.randint(0, c, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        rid = None
        if masked:
            rid = torch.arange(n, dtype=torch.int32, device=dev)
            drop = torch.rand(n, generator=gen, device=dev) < 0.1
            rid = torch.where(drop, torch.full_like(rid, -1), rid)
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        check_topk(f"gleanvec_sq_topk gathered M={m} C={c} d={d} N={n} "
                   f"k={k} {'u8' if u8 else 'f32'} row_ids="
                   f"{'with -1' if masked else 'none'}",
                   K.gleanvec_sq_topk(qs, qlo, tags, x, k, row_ids=rid),
                   K.gleanvec_sq_topk_plain(qs, qlo, tags, x, k,
                                            row_ids=rid), tol, testing)

    for m, c, d, lb, nb, cut, k, u8 in [(70, 6, 160, 4096, 5, 0, 100, True),
                                        (5, 7, 48, 64, 40, 0, 10, False),
                                        (3, 4, 16, 200, 7, 37, 100, False)]:
        n = nb * lb - cut
        qs, qlo = randn(m, c, d), randn(m, c)
        x = codes(n, d, u8)
        btags = torch.randint(0, c, (nb,), generator=gen, device=dev,
                              dtype=torch.int32)
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        perm[torch.rand(n, generator=gen, device=dev) < 0.2] = -1
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        check_topk(f"gleanvec_sq_topk sorted M={m} C={c} d={d} "
                   f"layout_block={lb} N={n} k={k} {'u8' if u8 else 'f32'}",
                   K.gleanvec_sq_topk(qs, qlo, btags, x, k, row_ids=perm,
                                      layout_block=lb),
                   K.gleanvec_sq_topk_plain(qs, qlo, btags, x, k,
                                            row_ids=perm, layout_block=lb),
                   tol, testing)

    # exact ties: identical rows must come out in ascending id order
    q, x = randn(4, 32), randn(1, 32).expand(1000, 32).contiguous()
    _, ids = K.ip_topk(q, x, 100)
    want = torch.arange(100, dtype=torch.int32, device=dev).expand(4, -1)
    if not torch.equal(ids, want):
        raise AssertionError("ip_topk: equal scores must break toward the "
                             "smaller id")
    log("  ip_topk exact ties: ids ascending as required")

    for n, d, c in [(10007, 512, 48), (999, 100, 7), (300, 64, 64)]:
        x = randn(n, d)
        cent = randn(c, d)
        check_kmeans(f"kmeans_assign N={n} D={d} C={c}", x, cent,
                     K.kmeans_assign(x, cent), K.kmeans_assign_plain(x, cent),
                     testing)
    cent = randn(8, 64)
    cent[5] = cent[2]
    cent[7] = cent[2]
    x = cent[2].expand(50, 64).contiguous() + 0.0
    tags, _ = K.kmeans_assign(x, cent)
    if not bool((tags == 2).all()):
        raise AssertionError("kmeans_assign: a tie must go to the first "
                             "center")
    log("  kmeans_assign exact ties: first center wins")


# ---------------------------------------------------------------------------
# Phase 3: the main path.
# ---------------------------------------------------------------------------


def phase_main(K):
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import leanvec_sphering as lvs
    from repro_torch.core import metrics
    from repro_torch.core import search as msearch
    from repro_torch.core.scorer import MODES
    from repro_torch.data import vectors
    from repro_torch.serve.engine import ServingEngine

    dev = torch.device("cuda")
    log(f"phase 3: main path, n={N_ROWS} D=512 d=160 C=48 batch=1024 "
        "k=10 kappa=100")
    t0 = time.perf_counter()
    ds = vectors.make_dataset("smoke", n=N_ROWS, d=512, n_queries=1024,
                              ood=True, seed=0, gt_device=dev)
    log(f"  data: {time.perf_counter() - t0:.1f} s (host generator, ground "
        "truth on the card)")
    x = torch.as_tensor(ds.database, device=dev)
    counters = (K.ip_topk, K.gleanvec_sq_topk, K.kmeans_assign)
    for fn in counters:
        fn.launches = 0

    t0 = time.perf_counter()
    sph = lvs.fit(ds.queries_learn, x, 160, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    glv = gv.fit(ds.queries_learn, x, c=48, d=160, generator=gen,
                 device=dev)
    torch.cuda.synchronize()
    log(f"  fit: {time.perf_counter() - t0:.1f} s "
        f"(kmeans_assign launches so far: {K.kmeans_assign.launches})")

    per_mode, states = {}, {}
    for mode in MODES:
        model = None if mode == "full" else (
            sph if mode.startswith("sphering") else glv)
        before = {fn.__name__: fn.launches for fn in counters}
        t0 = time.perf_counter()
        art = msearch.build_artifacts(mode, x, model, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        kappa = 10 if mode == "full" else 100
        engine = ServingEngine(msearch.make_state(art), k=10, kappa=kappa,
                               batch_size=1024, dim=512)
        ids = None
        for _ in range(5):
            ids = engine.submit(ds.queries_test)
        rec = metrics.recall_at_k(ids, ds.gt[:, :10])
        s = engine.stats
        delta = {fn.__name__: fn.launches - before[fn.__name__]
                 for fn in counters}
        per_mode[mode] = delta
        log(f"  mode={mode} encode={t_build:.2f}s batches={s.n_batches} "
            f"QPS={s.qps:.0f} p50={s.percentile_ms(50):.1f}ms "
            f"p99={s.percentile_ms(99):.1f}ms recall@10={rec:.4f} "
            f"(floor {RECALL_FLOORS[mode]}) launches={delta}")
        if not np.all((ids >= -1) & (ids < N_ROWS)) or ids.shape != (1024, 10):
            raise AssertionError(f"{mode}: malformed ids {ids.shape}")
        if rec < RECALL_FLOORS[mode]:
            raise AssertionError(f"{mode}: recall@10 {rec:.4f} below its "
                                 f"floor {RECALL_FLOORS[mode]}")
        q = torch.as_tensor(ds.queries_test, device=dev)
        states[mode] = (art.scorer, art.scorer.prepare_queries(q), kappa)
        del engine
    totals = {fn.__name__: fn.launches for fn in counters}
    log(f"  main-path launches: {totals}")
    for name, count in totals.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return x, glv, states, per_mode, totals


# ---------------------------------------------------------------------------
# Phase 4: each kernel at the main path's shapes.
# ---------------------------------------------------------------------------


def mode_calls(K, mode, scorer, qstate, kappa):
    """(kernel call, plain call, flops, bytes, tolerance, library call) of
    the scan a mode's FlatIndex runs, on its own inputs. The library call
    is ``torch.matmul`` + ``torch.topk`` for the linear modes; the GleanVec
    family has none that fits: its dense (M * C, N) scores take 393 GB."""
    from repro_torch import testing
    if mode in ("full", "sphering", "sphering-int8"):
        q = qstate if mode != "sphering-int8" else qstate.q_scaled
        x = scorer.x_low if mode != "sphering-int8" else scorer.codes
        m, d = q.shape
        n = x.shape[0]
        flops = 2.0 * m * n * d
        nbytes = q.numel() * 4 + x.numel() * x.element_size() + m * kappa * 8
        tol = testing.dot_tol(row_norm_max(q), row_norm_max(x), d)

        def library():
            return torch.topk(q @ x.to(torch.float32).T, kappa, dim=1)
        return (lambda: K.ip_topk(q, x, kappa),
                lambda: K.ip_topk_plain(q, x, kappa), flops, nbytes, tol,
                library)
    if mode.endswith("int8") or mode.endswith("int8-sorted"):
        qs, qlo, x = qstate.q_scaled, qstate.q_lo, scorer.codes
    else:
        qs, x = qstate, scorer.x_low
        qlo = torch.zeros(qs.shape[:2], dtype=torch.float32, device=qs.device)
    m, c, d = qs.shape
    if mode.endswith("sorted"):
        tags, rid, lb = scorer.block_tags, scorer.perm, scorer.layout_block
        n = int((rid >= 0).sum())
        extra = tags.numel() * 4 + n * 4
    else:
        tags, rid, lb = scorer.tags, None, 0
        n = x.shape[0]
        extra = n * 4
    flops = 2.0 * m * n * d
    nbytes = (qs.numel() + qlo.numel()) * 4 + n * d * x.element_size() \
        + extra + m * kappa * 8
    tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                          float(qlo.abs().max()))
    return (lambda: K.gleanvec_sq_topk(qs, qlo, tags, x, kappa, row_ids=rid,
                                       layout_block=lb),
            lambda: K.gleanvec_sq_topk_plain(qs, qlo, tags, x, kappa,
                                             row_ids=rid, layout_block=lb),
            flops, nbytes, tol, None)


def phase_timing(K, testing, x, glv, states, per_mode, totals):
    from repro_torch.core.spherical_kmeans import normalize_rows
    log("phase 4: kernels at the main path's shapes (CUDA events; bound = "
        "max(flops / 67 TFLOP/s fp32, bytes / 3.35 TB/s); library = "
        "composed PyTorch calls of the same function)")
    table = []
    for mode, (scorer, qstate, kappa) in states.items():
        name = "ip_topk" if mode in ("full", "sphering", "sphering-int8") \
            else "gleanvec_sq_topk"
        kern, plain, flops, nbytes, tol, library = mode_calls(
            K, mode, scorer, qstate, kappa)
        ms, out_k = timed(kern, 3)
        plain_ms, out_p = timed_once(plain)
        rep = check_topk(f"{name}[{mode}] vs plain", out_k, out_p, tol,
                         testing)
        b, by = bound_ms(flops, nbytes)
        lib_ms = timed(library, 2)[0] if library is not None else None
        log(f"  {name}[{mode}]: ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"bound_ms={b:.3f} ({by}) library_ms={lib_ms} "
            f"launches={per_mode[mode][name]}")
        src, repl = KERNEL_FILES[name]
        table.append({"name": f"{name}[{mode}]", "route": "cuda",
                      "source": src, "replaces": repl,
                      "launches": per_mode[mode][name],
                      "max_abs_err": rep["max_abs_err"], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                      "library_ms": lib_ms})
    x_unit = normalize_rows(x)
    cent = glv.centers.contiguous()
    n, d = x_unit.shape
    c = cent.shape[0]
    ms, out_k = timed(lambda: K.kmeans_assign(x_unit, cent), 3)
    plain_ms, out_p = timed_once(lambda: K.kmeans_assign_plain(x_unit, cent))
    err = check_kmeans("kmeans_assign vs plain", x_unit, cent, out_k, out_p,
                       testing)
    lib_ms, _ = timed(lambda: torch.max(x_unit @ cent.T, dim=1), 3)
    b, by = bound_ms(2.0 * n * c * d, n * d * 4 + c * d * 4 + n * 8)
    log(f"  kmeans_assign: ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"bound_ms={b:.3f} ({by}) library_ms={lib_ms:.3f} "
        f"launches={totals['kmeans_assign']}")
    src, repl = KERNEL_FILES["kmeans_assign"]
    table.append({"name": "kmeans_assign", "route": "cuda", "source": src,
                  "replaces": repl, "launches": totals["kmeans_assign"],
                  "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": b, "bound_by": by, "library_ms": lib_ms})
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build + ragged checks)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch import testing

    t_start = time.perf_counter()
    log("phase 1: card and build")
    card = card_line()
    log(f"  card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = K.build()
    log(f"  build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{k}={v:.1f}s" for k, v in built.items()))
    for name in K.KERNEL_SOURCES:
        log_path = Path(f"{K.library_path(name)}.log")
        if log_path.exists():
            ptxas = [ln.strip() for ln in log_path.read_text().splitlines()
                     if "registers" in ln or "spill" in ln]
            log(f"  {name} ptxas: " + " | ".join(ptxas[:12]))

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_kernels(K, testing, gen)
    torch.cuda.synchronize()
    if args.kernels_only:
        log(f"kernels-only: stopping after phase 2 "
            f"({time.perf_counter() - t_start:.0f} s)")
        return 0

    x, glv, states, per_mode, totals = phase_main(K)
    table = phase_timing(K, testing, x, glv, states, per_mode, totals)
    torch.cuda.synchronize()
    log(f"total: {time.perf_counter() - t_start:.0f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
