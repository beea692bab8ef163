"""Dry run on the production meshes: trace every (architecture x input
shape) cell's step once on fake tensors and read the roofline inputs (port
of the reference's ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] \\
        [--jobs 4]

The reference compiles each cell for 256 or 512 fake XLA devices and reads
``memory_analysis()``, ``cost_analysis()`` and the HLO text. Here there is
no compiler to ask: the step runs once under ``FakeTensorMode`` (shapes
and dtypes, no storage: nothing is allocated, and no GPU is needed) and a
dispatch mode (:class:`DispatchCounts`) counts every op as it is issued --
the products' flops by dtype (``torch.utils.flop_counter``'s formulas, and
the kernels' own counts for the custom ops ``repro_torch::*``), the bytes
each op writes (an in-place scatter its slice, a view nothing), the most
storage live at once above the arguments, and each collective's kind,
bytes and group. The port's layer and loss-chunk loops run in Python, so
every trip is counted; ``trip_counts`` is kept for the report.

Per device: arguments and outputs exactly, from the bundle's partition
specs (``sharding.local_block``). The steps that run on their local blocks
over a process group -- the ``vs_*`` steps, the LM steps (training,
prefill and decode, ``models/partitioned.py``) and DLRM's serve step with
its 2D lookup -- are traced at rank 0's blocks in a fake process group of
``mesh.size`` ranks (``"split": "traced"``); a step that fails there
raises, and is never traced whole instead. The GNN and the other
recommenders' steps have no partitioned execution in the port yet: they
are traced whole at global shapes on one position, and flops, bytes and
the activation peak are divided by ``mesh.size`` (``"split": "ideal"``,
no collectives).

A host read of a value the trace cannot know has one answer: the counts
of a ``bincount`` (the data pass's rows a cluster) are equal shares of its
input. Any other raises and the cell is not ok.

Each cell writes ``results/torch_dryrun/<arch>__<shape>__<mesh>.json``;
``--all`` runs one subprocess a cell (``--jobs`` at once) and skips cells
whose file exists (``--force`` to redo). The fake tensors lie on the card's
device type by default, so the trace follows the card's path; without a
GPU pass ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

RESULTS_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "torch_dryrun"))

__all__ = ["DispatchCounts", "fake_group", "trace_step", "run_cell",
           "cell_path", "all_cells", "RESULTS_DIR"]

_aten = torch.ops.aten
# in-place ops that write only the slice their index names: the elements
# written are those of this argument (by position)
_SLICE_WRITES = {"index_add_": 3, "index_copy_": 3, "scatter_": 2,
                 "scatter_add_": 2, "scatter_reduce_": 2, "put_": 1,
                 "index_reduce_": 3}
_COLLECTIVE_KINDS = (("reduce_scatter", "reduce-scatter"),
                     ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
                     ("allgather", "all-gather"), ("all_gather", "all-gather"),
                     ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
                     ("broadcast", "broadcast"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    return [t for t in torch.utils._pytree.tree_leaves(x)
            if isinstance(t, torch.Tensor)]


class DispatchCounts(TorchDispatchMode):
    """Counts every op dispatched under it (meant to sit above a
    ``FakeTensorMode``): ``flops`` {dtype name: flops} of the ops with a
    flop formula, at the dtype of their first floating input;
    ``write_bytes`` the bytes the ops write (fresh outputs whole, in-place
    ops their target, an index scatter its slice, views and collectives
    nothing); ``peak_bytes`` the most storage made under it and live at
    once; ``collectives`` {(kind, global ranks): [bytes, count]}, a
    collective's bytes its input's; ``n_ops``; ``answered`` the host reads
    answered from the data model (a bincount's equal shares)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops: Dict[str, float] = defaultdict(float)
        self.write_bytes = 0.0
        self.collectives: Dict[tuple, list] = {}
        self.n_ops = 0
        self.answered = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}
        self._bincounts: dict = {}      # storage -> (elements, bins)

    # -- storage ------------------------------------------------------------
    def _made(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        st = t.untyped_storage()
        key = StorageWeakRef(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        self._bincounts.pop(key, None)

    # -- ops ------------------------------------------------------------------
    def _collective(self, func, args, kwargs) -> None:
        import torch.distributed as dist
        name = func._overloadpacket.__name__
        kind = next((k for key, k in _COLLECTIVE_KINDS if key in name), name)
        group = None
        for a in torch.utils._pytree.tree_leaves((args, kwargs)):
            if isinstance(a, dist.ProcessGroup):
                group = a
            elif isinstance(a, torch.ScriptObject) and \
                    "ProcessGroup" in a._type().qualified_name():
                group = dist.ProcessGroup.unbox(a)
        if group is None:               # functional collectives: a name
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            group = _resolve_process_group(args[-1])
        ranks = tuple(dist.get_process_group_ranks(group))
        if len(ranks) < 2:
            return                      # one rank moves no bytes
        ins = args[1] if name.startswith(("_allgather_base", "allgather",
                                          "_reduce_scatter_base",
                                          "reduce_scatter", "alltoall")) \
            else args[0]
        entry = self.collectives.setdefault((kind, ranks), [0, 0])
        entry[0] += sum(_nbytes(t) for t in _tensors(ins))
        entry[1] += 1

    def _answer(self, t: torch.Tensor):
        """A host read of one element of a bincount's output: its equal
        share of the input's elements (the first ``rest`` bins one more)."""
        from torch.multiprocessing.reductions import StorageWeakRef
        hint = self._bincounts.get(StorageWeakRef(t.untyped_storage()))
        if hint is None or t.numel() != 1:
            raise RuntimeError(
                "dry run: the step reads a value from the device that the "
                "trace cannot know (only a bincount's counts are modelled)")
        n, bins = hint
        self.answered += 1
        i = t.storage_offset()
        return n // bins + (1 if i < n % bins else 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.n_ops += 1
        if func is _aten._local_scalar_dense.default:
            return self._answer(args[0])
        if func is _aten.bincount.default and _plain_bincount(args, kwargs):
            x, bins = args[0], kwargs.get("minlength", args[2])
            out = torch.zeros(bins, dtype=torch.int64, device=x.device)
            self._made(out)
            from torch.multiprocessing.reductions import StorageWeakRef
            self._bincounts[StorageWeakRef(out.untyped_storage())] = (
                x.numel(), bins)
            self.write_bytes += _nbytes(out)
            return out
        if func.namespace in ("c10d", "_c10d_functional"):
            self._collective(func, args, kwargs)
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            dt = next((t.dtype for t in _tensors((args, kwargs))
                       if t.is_floating_point()), torch.float32)
            self.flops[str(dt).replace("torch.", "")] += float(
                formula(*args, **kwargs, out_val=out))
        self._writes(func, args, out)
        return out

    def _writes(self, func, args, out) -> None:
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) and len(returns) > 1 \
            else (out,)
        name = func._overloadpacket.__name__
        for ret, val in zip(returns, outs):
            alias = ret.alias_info
            ts = _tensors(val)
            if alias is None:                       # fresh storage
                for t in ts:
                    self._made(t)
                    self.write_bytes += _nbytes(t)
            elif alias.is_write:                    # in place / out=
                if name in _SLICE_WRITES:
                    src = args[_SLICE_WRITES[name]]
                    n = src.numel() if isinstance(src, torch.Tensor) else 1
                    self.write_bytes += n * ts[0].element_size()
                elif name in ("index_put_", "_index_put_impl_"):
                    self.write_bytes += _index_put_elements(args) \
                        * ts[0].element_size()
                else:
                    self.write_bytes += sum(_nbytes(t) for t in ts)


def _plain_bincount(args, kwargs) -> bool:
    """An unweighted bincount with ``minlength`` bins (the data pass's
    rows a cluster): the one host-read value the trace models."""
    weights = kwargs.get("weights", args[1] if len(args) > 1 else None)
    bins = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
    return weights is None and bins > 0


def _index_put_elements(args) -> int:
    """Elements ``index_put_(self, indices, values)`` writes: the indexed
    positions (boolean masks counted by ``values``)."""
    self_, indices, values = args[0], args[1], args[2]
    idx = [i for i in indices if i is not None]
    if not idx or any(i.dtype == torch.bool for i in idx):
        return values.numel()
    n = 1
    for s in torch.broadcast_shapes(*(i.shape for i in idx)):
        n *= s
    for s in self_.shape[len(indices):]:
        n *= s
    return max(n, values.numel())


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake ``torch.distributed`` default group of ``world_size`` ranks,
    this process rank 0 (collectives return at once, moving nothing);
    destroyed on exit. Nothing when ``world_size`` is 1."""
    import torch.distributed as dist
    if world_size <= 1:
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Specs over trees.
# ---------------------------------------------------------------------------


def _spec_leaves(tree_, specs):
    """[(tensor, spec)] of ``tree_`` under the spec tree ``specs``: a
    ``PartitionSpec`` covers every tensor below it, None replicates."""
    from repro_torch.models.sharding import PartitionSpec
    if isinstance(tree_, torch.Tensor):
        return [(tree_, specs if isinstance(specs, PartitionSpec) else ())]
    if specs is None or isinstance(specs, PartitionSpec):
        return [(t, specs or ()) for t in _tensors(tree_)]
    if isinstance(tree_, dict):
        return [p for k in tree_ for p in _spec_leaves(tree_[k], specs[k])]
    if isinstance(tree_, (tuple, list)):
        return [p for x, s in zip(tree_, specs) for p in _spec_leaves(x, s)]
    return []


def _local_shape(t: torch.Tensor, spec, mesh) -> tuple:
    from repro_torch.models.sharding import local_block
    coords = {a: 0 for a in mesh.axis_names}
    meta = torch.empty(t.shape, dtype=t.dtype, device="meta")
    return tuple(local_block(meta, spec, mesh, coords).shape)


def _per_device_bytes(tree_, specs, mesh) -> int:
    total = 0
    for t, spec in _spec_leaves(tree_, specs):
        n = t.element_size()
        for s in _local_shape(t, spec, mesh):
            n *= s
        total += n
    return total


def _fake_args(args, specs, mesh, device):
    """The abstract ``args`` as empty fake tensors on ``device``: each
    leaf at its local block under ``specs`` where given, else whole."""
    pairs = {id(t): spec for t, spec in _spec_leaves(args, specs)} \
        if specs is not None else {}

    def make(x):
        if not isinstance(x, torch.Tensor):
            return x
        shape = _local_shape(x, pairs[id(x)], mesh) if id(x) in pairs \
            else tuple(x.shape)
        return torch.empty(shape, dtype=x.dtype, device=device)

    return torch.utils._pytree.tree_map(make, args)


# ---------------------------------------------------------------------------
# One trace, one cell.
# ---------------------------------------------------------------------------


def trace_step(fn, args, *, device="cuda", mesh=None, in_specs=None) -> dict:
    """Run ``fn(*args)`` once on fake tensors on ``device`` under
    :class:`DispatchCounts`; ``args`` abstract tensors (any device, shapes
    and dtypes read), cut to rank 0's local blocks under ``in_specs`` on
    ``mesh`` where both are given. Returns {``flops_by_dtype``,
    ``write_bytes``, ``temp_peak_bytes`` (the most storage made by the
    step live at once), ``argument_bytes``, ``output_bytes`` and
    ``alias_bytes`` (outputs that are arguments, updated in place),
    ``collectives`` [{``kind``, ``bytes``, ``count``, ``ranks``}],
    ``n_ops``, ``answered``, ``trace_s``, ``outputs`` (the fake outputs)}."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.multiprocessing.reductions import StorageWeakRef
    with FakeTensorMode() as fake:
        fargs = _fake_args(args, in_specs if mesh is not None else None,
                           mesh, device)
    arg_store = {StorageWeakRef(t.untyped_storage())
                 for t in _tensors(fargs)}
    counts = DispatchCounts()
    t0 = time.perf_counter()
    with fake, counts:
        out = fn(*fargs)
    trace_s = time.perf_counter() - t0
    outs = _tensors(out)
    alias = sum(_nbytes(t) for t in outs
                if StorageWeakRef(t.untyped_storage()) in arg_store)
    return {
        "flops_by_dtype": dict(counts.flops),
        "write_bytes": counts.write_bytes,
        "temp_peak_bytes": counts.peak_bytes,
        "argument_bytes": sum(_nbytes(t) for t in _tensors(fargs)),
        "output_bytes": sum(_nbytes(t) for t in outs),
        "alias_bytes": alias,
        "collectives": [{"kind": k, "ranks": list(r), "bytes": v[0],
                         "count": v[1]}
                        for (k, r), v in counts.collectives.items()],
        "n_ops": counts.n_ops, "answered": counts.answered,
        "trace_s": trace_s, "outputs": out,
    }


def split_of(arch: str, shape: str, smoke: bool, mesh) -> str:
    """"traced" where the step runs on its local blocks over a process
    group (the ``vs_*`` steps; the LM steps, training, prefill and decode;
    DLRM's serve step with its 2D lookup, which smoke configs and meshes
    without a "model" axis do not take), or on one position; else
    "ideal"."""
    from repro_torch.configs import registry
    module = registry.get(arch)
    if mesh.size == 1 or module.FAMILY == "vectorsearch":
        return "traced"
    if module.FAMILY == "lm":
        return "traced"
    if getattr(module, "MODEL", "") == "dlrm" and not smoke \
            and module.SHAPES[shape]["kind"] == "recsys_serve" \
            and "model" in mesh.axis_names:
        return "traced"
    return "ideal"


def record_of(arch: str, shape: str, mesh_kind: str, bundle, mesh, trace,
              split: str) -> dict:
    """The cell's record from its bundle (production specs) and trace."""
    from repro_torch.utils import roofline
    n = mesh.size
    div = 1 if split == "traced" else n
    flops_dt = {k: v / div for k, v in trace["flops_by_dtype"].items()}
    flops = sum(flops_dt.values())
    write = trace["write_bytes"] / div
    colls = trace["collectives"]
    coll_bytes = float(sum(c["bytes"] for c in colls))
    by_kind: Dict[str, float] = defaultdict(float)
    for c in colls:
        by_kind[c["kind"]] += c["bytes"]
    arg_b = _per_device_bytes(bundle.args, bundle.in_specs or None, mesh)
    if split == "traced":
        out_b = trace["output_bytes"]
        alias_b = trace["alias_bytes"]
    else:
        out_b = _per_device_bytes(trace["outputs"], bundle.out_specs, mesh)
        alias_b = trace["alias_bytes"] / div
    made = trace["temp_peak_bytes"] / div
    temp = max(0.0, made - (out_b - alias_b))
    peak = arg_b + temp + out_b - alias_b
    stats = {"dot_flops": flops, "dot_flops_by_dtype": flops_dt,
             "write_bytes": write, "collective_bytes": coll_bytes,
             "collectives": [{"bytes": c["bytes"], "ranks": c["ranks"]}
                             for c in colls]}
    terms = roofline.compute_terms({"flops": flops}, stats,
                                   bundle.model_flops, n, roofline.H100)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "n_chips": n,
        "ok": True, "split": split, "trace_s": round(trace["trace_s"], 3),
        "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                   "alias_bytes": alias_b, "temp_bytes": temp,
                   "peak_bytes": peak,
                   "fits_h100_80g": peak < roofline.H100.hbm_bytes},
        "cost": {"flops": flops, "flops_by_dtype": flops_dt,
                 "bytes_written": write},
        "collectives": {"bytes": coll_bytes, "by_kind": dict(by_kind),
                        "count": sum(c["count"] for c in colls),
                        "groups": [{k: c[k] for k in ("kind", "bytes",
                                                      "count")}
                                   | {"n_ranks": len(c["ranks"]),
                                      "link": "nvlink" if
                                      roofline.collective_link_bw(
                                          c["ranks"]) ==
                                      roofline.H100.ici_bw else "network"}
                                   for c in colls]},
        "trip_counts": dict(bundle.trip_counts),
        "roofline": terms.to_dict(),
        "ops": trace["n_ops"], "answered_reads": trace["answered"],
        "notes": bundle.notes,
    }


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run traces the card's path on fake "
                           "CUDA tensors and this torch has no CUDA; pass "
                           "device='cpu' (--device cpu) to trace the CPU's")
    return dev


def run_cell(arch: str, shape: str, mesh_kind: str, smoke: bool = False,
             device: str = "cuda", mesh=None) -> dict:
    """Trace one cell on the production mesh of ``mesh_kind`` (``single``
    (16, 16) or ``multi`` (2, 16, 16); or ``mesh`` given) and return its
    record."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import build_bundle
    if mesh is None:
        mesh = mesh_mod.make_production_mesh(multi_pod=mesh_kind == "multi")
    dev = _check_device(device)
    bundle = build_bundle(arch, shape, smoke=smoke, device="cpu", mesh=mesh)
    split = split_of(arch, shape, smoke, mesh)
    if split == "traced":
        with fake_group(mesh.size):
            trace = trace_step(bundle.fn, bundle.args, device=dev, mesh=mesh,
                               in_specs=bundle.in_specs)
    else:
        one = mesh_mod.Mesh(("data",), (1,))
        fn = build_bundle(arch, shape, smoke=smoke, device="cpu",
                          mesh=one).fn
        trace = trace_step(fn, bundle.args, device=dev)
    return record_of(arch, shape, mesh_kind, bundle, mesh, trace, split)


def cell_path(arch: str, shape: str, mesh_kind: str) -> str:
    safe = f"{arch}__{shape}__{mesh_kind}".replace("/", "_")
    return os.path.join(RESULTS_DIR, safe + ".json")


def all_cells():
    from repro_torch.configs.registry import ARCHS
    return [(arch, shape) for arch, mod in ARCHS.items()
            for shape in mod.SHAPES if shape not in getattr(mod, "SKIPS", {})]


def _summary(rec: dict) -> str:
    r = rec["roofline"]
    return (f"{rec['arch']}:{rec['shape']}:{rec['mesh']} ok "
            f"split={rec['split']} trace={rec['trace_s']}s "
            f"peak/dev={rec['memory']['peak_bytes'] / 1e9:.2f}GB "
            f"terms(c/m/n)={r['compute_s']:.2e}/{r['memory_s']:.2e}/"
            f"{r['collective_s']:.2e}s bottleneck={r['bottleneck']}")


def _sweep(meshes, args) -> int:
    todo = [(a, s, m) for a, s in all_cells() for m in meshes]
    running, failures, t0 = [], [], time.perf_counter()

    def reap(block: bool) -> None:
        for item in list(running):
            proc, (arch, shape, mk), started = item
            if block is False and proc.poll() is None:
                if time.perf_counter() - started < args.timeout:
                    continue
                proc.kill()
            out, err = proc.communicate()
            running.remove(item)
            if proc.returncode != 0:
                failures.append((arch, shape, mk))
                print(f"    FAILED {arch}:{shape}:{mk}:\n{out[-2000:]}\n"
                      f"{err[-2000:]}", flush=True)
            else:
                print("    " + out.strip().splitlines()[-1], flush=True)

    for i, (arch, shape, mk) in enumerate(todo):
        if os.path.exists(cell_path(arch, shape, mk)) and not args.force:
            print(f"[{i + 1}/{len(todo)}] SKIP (cached) {arch}:{shape}:{mk}")
            continue
        while len(running) >= args.jobs:
            reap(False)
            time.sleep(0.05)
        print(f"[{i + 1}/{len(todo)}] RUN {arch}:{shape}:{mk}", flush=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mk, "--device", args.device]
        running.append((subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="1")), (arch, shape, mk),
            time.perf_counter()))
    while running:
        reap(False)
        time.sleep(0.05)
    print(f"\ndone: {len(todo) - len(failures)}/{len(todo)} ok in "
          f"{time.perf_counter() - t0:.1f} s")
    if failures:
        print("failures:", failures)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells traced at once, one process each")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake tensors (the card's "
                    "path by default; cpu where torch has no CUDA)")
    args = ap.parse_args(argv)

    _check_device(args.device)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        return _sweep(meshes, args)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    for mk in meshes:
        path = cell_path(args.arch, args.shape, mk)
        try:
            rec = run_cell(args.arch, args.shape, mk, device=args.device)
        except Exception as e:
            rec = {"arch": args.arch, "shape": args.shape, "mesh": mk,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"{args.arch}:{args.shape}:{mk} FAILED: {rec['error']}")
            return 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(_summary(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
