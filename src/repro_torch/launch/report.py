"""Render the dry run's records (``results/torch_dryrun/``) into the dry-run
and roofline tables (port of the reference's ``repro/launch/report.py``;
memory against the H100's 80 GB, the roofline from its spec sheet).

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh single]
    PYTHONPATH=src python -m repro_torch.launch.report --table summary
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR


def load(mesh: str, results_dir: str = RESULTS_DIR):
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir,
                                              f"*__{mesh}.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return [r for r in rows if r.get("ok")]


def fmt_bytes(b):
    return f"{b / 1e9:.2f}"


def dryrun_table(rows):
    out = ["| arch | shape | trace s | peak GB/dev | fits 80G | "
           "GFLOP/dev | coll GB/dev | top collectives |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        c = r["collectives"]
        kinds = sorted(c["by_kind"].items(), key=lambda kv: -kv[1])[:2]
        kinds_s = " ".join(f"{k}:{v/1e9:.1f}G" for k, v in kinds) or "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['trace_s']} | "
            f"{fmt_bytes(r['memory']['peak_bytes'])} | "
            f"{'Y' if r['memory']['fits_h100_80g'] else 'N'} | "
            f"{r['roofline']['hlo_flops'] / 1e9:.1f} | "
            f"{c['bytes'] / 1e9:.2f} | {kinds_s} |")
    return "\n".join(out)


def roofline_table(rows):
    out = ["| arch | shape | split | compute s | memory s | collective s | "
           "bottleneck | MODEL_FLOPS | useful | peak frac |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['split']} | "
            f"{rf['compute_s']:.3e} | "
            f"{rf['memory_s']:.3e} | {rf['collective_s']:.3e} | "
            f"**{rf['bottleneck']}** | {rf['model_flops_total']:.2e} | "
            f"{rf['useful_flops_ratio']:.2f} | {rf['peak_fraction']:.4f} |")
    return "\n".join(out)


def summary_table(single, multi):
    """Both production meshes side by side, a row a cell: each mesh's
    bound (ms; c, m, n: compute, memory or collective bound it) and peak
    GB a device."""
    other = {(r["arch"], r["shape"]): r for r in multi}
    out = ["| arch | shape | split | bound ms (16x16) | bound ms (2x16x16) "
           "| peak GB/dev (16x16 / 2x16x16) |", "|---|---|---|---|---|---|"]

    def bound(r):
        if r is None:
            return "-"
        rf = r["roofline"]
        initial = {"compute": "c", "memory": "m", "collective": "n"}
        return f"{rf['bound_s'] * 1e3:.4g} {initial[rf['bottleneck']]}"

    for r in single:
        m = other.get((r["arch"], r["shape"]))
        peak_m = fmt_bytes(m["memory"]["peak_bytes"]) if m else "-"
        out.append(f"| {r['arch']} | {r['shape']} | {r['split']} | "
                   f"{bound(r)} | {bound(m)} | "
                   f"{fmt_bytes(r['memory']['peak_bytes'])} / {peak_m} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--table", default="both",
                    choices=["dryrun", "roofline", "both", "summary"])
    args = ap.parse_args(argv)
    if args.table == "summary":
        print("### Roofline, both production meshes (predictions from the "
              "H100 spec sheet, not measurements; c / m / n: compute, "
              "memory, collective)\n")
        print(summary_table(load("single"), load("multi")))
        return
    rows = load(args.mesh)
    if args.table in ("dryrun", "both"):
        print(f"### Dry-run ({args.mesh} mesh, "
              f"{rows[0]['n_chips'] if rows else '?'} chips)\n")
        print(dryrun_table(rows))
        print()
    if args.table in ("roofline", "both"):
        print(f"### Roofline ({args.mesh} mesh; predictions from the "
              "H100 spec sheet, not measurements)\n")
        print(roofline_table(rows))


if __name__ == "__main__":
    main()
