"""Step-trace rules: checks on what one serving call actually does (in
place of the reference's ``hlo_rules.py`` and ``utils/hlo_analysis.py``).

The reference reads these contracts off a compiled program's HLO. PyTorch
runs eagerly and has no such program, so the port runs the call once and
records it (:class:`StepTrace`):

* every aten op it dispatches (a ``TorchDispatchMode``): its name, its
  output shapes, dtypes and devices, its input shapes, and the kernel plain
  version it ran inside, if any (``*_plain`` functions of
  :mod:`repro_torch.kernels`: on CPU tensors every kernel wrapper runs its
  plain version). Tensors that the kernel wrappers allocate through torch
  are seen; the ctypes launches are not;
* on a CUDA device also the synchronizing calls
  (``torch.cuda.set_sync_debug_mode("warn")``, :func:`sync_count`), the
  peak of ``torch.cuda.max_memory_allocated`` above the call's starting
  allocation, and the device kernels launched (``torch.profiler``, in a
  second run of the call: :func:`device_split`).

The rules:

* :class:`NoDenseScoreMatrix` -- no op output of a forbidden (rows, cols)
  shape in f32 / i32; on a card also a peak above the start below
  rows * cols * 4 bytes, which no buffer of those elements fits under
  whatever its shape. An output made only inside a kernel's plain version
  (the CPU, where the plain versions score one (M, block) tile at a time
  with ``block`` up to 65536) makes the rule skip, naming the op: the card
  runs the kernel there.
* :class:`BufferPresent` -- the positive twin, for the dense scoring
  calls the fused paths are measured against.
* :class:`NoGatherOnFusedPath` -- no ``index_select`` / ``index.Tensor`` /
  ``gather`` / ``take`` output above a byte budget; gathers inside the
  plain versions make it skip with the op named (the reference skips under
  Pallas interpret mode the same way).
* :class:`NoHostSyncInStep` -- zero synchronizing calls (a card rule: it
  skips on the CPU).
* :class:`LaunchBudget` -- in place of ``WhileTripBudget``: the device
  kernels of one step stay within a budget, and ``exact`` pins a kernel's
  launches (a card rule).
* :class:`SwapWithoutCopy` -- in place of ``DonationCoverage`` (the port
  never donates: the engine keeps serving the installed state until the
  swap): after ``ServingEngine.swap(new)`` the engine's leaves are
  ``new``'s tensors, the old state's own tensors are freed once the caller
  drops them, and on a card ``memory_allocated`` is what it was before the
  swap.
"""
from __future__ import annotations

import gc
import os
import sys
import time
import warnings
import weakref
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.analysis.registry import Rule, RuleResult

__all__ = ["OpRecord", "StepTrace", "SwapCase", "NoDenseScoreMatrix",
           "BufferPresent", "NoGatherOnFusedPath", "NoHostSyncInStep",
           "LaunchBudget", "SwapWithoutCopy", "sync_count", "device_split",
           "profile_kernels"]

_KERNELS_DIR = os.path.realpath(Path(__file__).parents[1] / "kernels")

_DTYPES = {"f32": torch.float32, "s32": torch.int32}
_SHORT = {v: k for k, v in _DTYPES.items()}

# aten ops that gather rows (their outputs are what the budget bounds)
GATHER_OPS = ("aten.index_select.", "aten.index.Tensor", "aten.gather.",
              "aten.take.")


def _key(shape, dtype) -> str:
    name = _SHORT.get(dtype, str(dtype).replace("torch.", ""))
    return f"{name}[{','.join(str(int(d)) for d in shape)}]"


class OpRecord(NamedTuple):
    """One dispatched aten op. ``outputs``: (shape, dtype, device) of each
    tensor it returned; ``inputs``: the shapes of its tensor arguments;
    ``plain``: the kernel plain version it ran inside ("" outside)."""

    name: str
    outputs: tuple
    inputs: tuple
    plain: str = ""

    def out_bytes(self) -> int:
        return sum(_numel(s) * dt.itemsize for s, dt, _ in self.outputs)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _tensors(obj) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(obj) if isinstance(t, torch.Tensor)]


_IN_KERNELS: Dict[str, bool] = {}


def _in_kernels(filename: str) -> bool:
    hit = _IN_KERNELS.get(filename)
    if hit is None:
        hit = _IN_KERNELS[filename] = os.path.realpath(filename).startswith(
            _KERNELS_DIR + os.sep)
    return hit


def _plain_frame(frame) -> str:
    """Name of the innermost ``*_plain`` function of the kernel packages on
    the stack above ``frame``, or ""."""
    while frame is not None:
        code = frame.f_code
        if code.co_name.endswith("_plain") and _in_kernels(code.co_filename):
            return code.co_name
        frame = frame.f_back
    return ""


def _recorder(ops: List[OpRecord]):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ops.append(OpRecord(
                name=str(func),
                outputs=tuple((tuple(t.shape), t.dtype, t.device.type)
                              for t in _tensors(out)),
                inputs=tuple(tuple(t.shape)
                             for t in _tensors((args, kwargs))),
                plain=_plain_frame(sys._getframe(1))))
            return out

    return _Record()


class _SyncWarnings:
    """Count the warnings of ``torch.cuda.set_sync_debug_mode("warn")``
    ("called a synchronizing CUDA operation"; the mode's own notice that it
    is a prototype is not one) over the ``with`` block."""

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        self.count = 0
        return self

    def __exit__(self, *exc):
        try:
            torch.cuda.set_sync_debug_mode("default")
        finally:
            self._catch.__exit__(*exc)
        self.count = sum("called a synchronizing" in str(w.message)
                         for w in self._caught)
        return False


def sync_count(fn) -> int:
    """Host syncs ``fn`` makes: the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")`` ("called a synchronizing CUDA
    operation"; the mode's own notice that it is a prototype is not one)."""
    torch.cuda.synchronize()
    with _SyncWarnings() as sw:
        fn()
    return sw.count


# Kernels launched before and after a profiled call: on an H100 the
# profiler loses device events at a session's edges, from a few to
# hundreds, and more as a process ages (a session of a few kernels then
# often records none). On each side PAD_LAUNCHES spins of ~10 us and
# BURST_PAD_LAUNCHES of ~0.05 us take the loss in the call's place; pads
# recorded on both sides show the call's events came through. Pads are
# left out of the counts.
PAD_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel
PAD_LAUNCHES = 16
PAD_CYCLES = 20_000
BURST_PAD_LAUNCHES = 2048
BURST_PAD_CYCLES = 100
PROFILE_TRIES = 3


def _pads():
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(PAD_CYCLES)
    for _ in range(BURST_PAD_LAUNCHES):
        torch.cuda._sleep(BURST_PAD_CYCLES)
    torch.cuda.synchronize()


def _device_us(ev) -> float:
    us = getattr(ev, "device_time_total", None)
    return getattr(ev, "cuda_time_total", 0) if us is None else us


def profile_kernels(fn):
    """One call of ``fn`` under ``torch.profiler`` (after one empty start-up
    of the tracer), between ``PAD_LAUNCHES + BURST_PAD_LAUNCHES`` pad
    kernels on each side:
    (host-clock ms of the session, [(name, launches, device us)] of every
    device activity of ``fn``: kernels, copies and sets, intact). ``intact``
    says pads were recorded before and after ``fn``'s events, so none of
    those was lost at the edges; a session that is not is run again, up to
    ``PROFILE_TRIES`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):    # the tracer's first start-up
        torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            _pads()
            fn()
            torch.cuda.synchronize()
            _pads()
        wall = (time.perf_counter() - t0) * 1e3
        evs = sorted((e for e in prof.events()
                      if getattr(e, "device_type", None) == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        pad = [PAD_KERNEL in e.name for e in evs]
        real = [i for i, p in enumerate(pad) if not p]
        intact = (any(pad[:real[0]]) and any(pad[real[-1] + 1:])) if real \
            else sum(pad) > PAD_LAUNCHES + BURST_PAD_LAUNCHES
        rows: Dict[str, list] = {}
        for i in real:
            row = rows.setdefault(evs[i].name, [0, 0.0])
            row[0] += 1
            row[1] += _device_us(evs[i])
        if intact:
            break
    return wall, [(k, c, us) for k, (c, us) in rows.items()], intact


def device_split(fn, kernel_key: str):
    """One call of ``fn`` under ``torch.profiler``: (host-clock ms, device
    busy ms, device ms of the kernels whose name holds ``kernel_key``,
    device kernels launched, launches of those kernels); busy is 0 when the
    profiler records no device time on this machine."""
    wall, rows, _ = profile_kernels(fn)
    hit_us = all_us = 0.0
    kernels = hits = 0
    for key, count, us in rows:
        all_us += us
        kernels += count
        if kernel_key in key:
            hit_us += us
            hits += count
    return wall, all_us / 1e3, hit_us / 1e3, kernels, hits


def _device_of(obj) -> torch.device:
    from repro_torch import tree
    for leaf in tree.leaves(obj):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return torch.device("cpu")


class StepTrace:
    """One call as the trace rules see it: its ops, and on a CUDA device
    its synchronizing calls, peak memory above the start and device
    kernels. ``None`` marks a reading the device cannot give (the CPU)."""

    def __init__(self, ops: Sequence[OpRecord], device: str = "cpu",
                 syncs: Optional[int] = None,
                 peak_bytes: Optional[int] = None,
                 kernels: Optional[Dict[str, int]] = None, label: str = ""):
        self.ops = list(ops)
        self.device = device
        self.syncs = syncs
        self.peak_bytes = peak_bytes
        self.kernels = kernels
        self.label = label

    @classmethod
    def of(cls, fn, *args, label: str = "", **kwargs) -> "StepTrace":
        """Run ``fn(*args, **kwargs)`` once under the op recorder (on a
        CUDA device also counting syncs and the memory peak; there once
        more under ``torch.profiler`` for its kernels). The call must not
        change its inputs: the serving steps do not."""
        dev = _device_of((args, kwargs))
        ops: List[OpRecord] = []
        if dev.type != "cuda":
            with _recorder(ops):
                fn(*args, **kwargs)
            return cls(ops, "cpu", label=label)
        torch.cuda.synchronize(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with _SyncWarnings() as sw:
            with _recorder(ops):
                out = fn(*args, **kwargs)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - start
        del out
        _, rows, intact = profile_kernels(lambda: fn(*args, **kwargs))
        kernels = {key: count for key, count, _ in rows} if intact else None
        return cls(ops, "cuda", syncs=sw.count, peak_bytes=peak,
                   kernels=kernels, label=label)

    def outputs(self, dims: Sequence[int], dtypes) -> List[tuple]:
        """(op name, shape key, plain) of every op output of shape ``dims``
        and a dtype in ``dtypes``."""
        dims = tuple(int(d) for d in dims)
        return [(op.name, _key(s, dt), op.plain) for op in self.ops
                for s, dt, _ in op.outputs if s == dims and dt in dtypes]

    def gathers(self) -> List[OpRecord]:
        return [op for op in self.ops if op.name.startswith(GATHER_OPS)]

    @property
    def n_kernels(self) -> Optional[int]:
        return None if self.kernels is None else sum(self.kernels.values())


class _ShapeRule(Rule):
    family = "trace"

    def __init__(self, *dims: int, dtypes: Sequence[str] = ("f32", "s32"),
                 peak: bool = True):
        self.dims = tuple(int(d) for d in dims)
        self.dtypes = tuple(_DTYPES[d] for d in dtypes)
        self.keys = [_key(self.dims, dt) for dt in self.dtypes]
        self.peak = peak


def _named(hits) -> str:
    return ", ".join(sorted({f"{name} -> {key}" + (f" in {plain}" if plain
                                                   else "")
                             for name, key, plain in hits}))


class NoDenseScoreMatrix(_ShapeRule):
    """FORBIDDEN buffer shapes: a fused path's memory win is that no
    buffer of the dense score-matrix shape is made (scores f32, ids i32);
    on a card the step's peak above its start also stays below the bytes
    of such a buffer. ``peak=False`` checks the shapes alone, for a
    forbidden buffer no larger than the step's own working set (a graph
    hop's (m, expand * degree) scores, the audit matrix's M = 8 rows),
    where the peak cannot tell one from the other."""

    name = "NoDenseScoreMatrix"
    contract = ("no fused-path step makes a dense score-matrix buffer of "
                "the forbidden (rows, cols) shape; on a card its peak "
                "memory above the start stays below rows * cols * 4 B")

    def check(self, trace: StepTrace) -> RuleResult:
        hits = trace.outputs(self.dims, self.dtypes)
        outside = [h for h in hits if not h[2]]
        limit = self.dims[0] * self.dims[1] * 4
        problems = []
        if outside:
            problems.append(f"forbidden dense buffer(s) made: "
                            f"{_named(outside)}")
        peak = trace.peak_bytes if self.peak else None
        if peak is not None and peak >= limit:
            problems.append(f"peak {peak} B above the start >= "
                            f"{limit} B of a {self.keys[0]} buffer")
        if problems:
            return self._fail("; ".join(problems))
        if hits:
            return self._skip(
                f"{trace.device}: made only inside the kernels' plain "
                f"versions ({_named(hits)}); the card runs the kernels")
        mem = "" if peak is None else \
            f"; peak {peak} B above the start < {limit} B"
        return self._pass(f"none of {self.keys} made in "
                          f"{len(trace.ops)} ops{mem}")


class BufferPresent(_ShapeRule):
    """The positive twin (dense scoring calls DO make the matrix): at
    least one of the shapes must be made, inside a plain version or not.
    Keeps the forbidden-shape checks honest about what they compare."""

    name = "BufferPresent"
    contract = ("the dense scoring call really makes the buffer the fused "
                "path is measured against")

    def check(self, trace: StepTrace) -> RuleResult:
        hits = trace.outputs(self.dims, self.dtypes)
        if hits:
            return self._pass(f"present: {_named(hits)}")
        return self._fail(f"expected one of {self.keys}; the step makes "
                          "none")


class NoGatherOnFusedPath(Rule):
    """No gather whose result exceeds ``max_bytes`` on a fused path: the
    kernels stream the layout's slabs instead of gathering rows. Gathers
    inside the kernels' plain versions (the CPU) make it skip, naming
    them."""

    name = "NoGatherOnFusedPath"
    family = "trace"
    contract = ("fused paths make no row gather (index_select / index / "
                "gather / take) above the byte budget")

    def __init__(self, max_bytes: int = 0):
        self.max_bytes = int(max_bytes)

    def check(self, trace: StepTrace) -> RuleResult:
        big = [op for op in trace.gathers()
               if op.out_bytes() > self.max_bytes]

        def named(ops):
            return ", ".join(sorted({
                f"{op.name} -> {_key(*op.outputs[0][:2])}="
                f"{op.out_bytes()}B" + (f" in {op.plain}" if op.plain
                                        else "") for op in ops}))

        outside = [op for op in big if not op.plain]
        if outside:
            return self._fail(f"gather result(s) over {self.max_bytes}B: "
                              f"{named(outside)}")
        if big:
            return self._skip(
                f"{trace.device}: the kernels' plain versions gather "
                f"({named(big)}); the contract holds where the kernels run")
        return self._pass(f"no gather above {self.max_bytes}B "
                          f"({len(trace.gathers())} gathers)")


_SYNC_OPS = ("aten._local_scalar_dense.", "aten.nonzero.",
             "aten.masked_select.", "aten.unique")


class NoHostSyncInStep(Rule):
    """Serving steps never wait for the device: zero synchronizing calls
    (``torch.cuda.set_sync_debug_mode``) in the step, so a pipelined
    engine's next batch is never serialised behind this one. A card rule:
    CPU tensors never synchronize."""

    name = "NoHostSyncInStep"
    family = "trace"
    contract = ("a serving step makes no synchronizing CUDA call (the "
                "rerank tier's host gather stays outside)")

    def check(self, trace: StepTrace) -> RuleResult:
        if trace.syncs is None:
            return self._skip(f"{trace.device}: synchronizing calls are "
                              "counted on a CUDA device only")
        if trace.syncs:
            suspects = sorted({op.name for op in trace.ops
                               if op.name.startswith(_SYNC_OPS)
                               or any(o[2] == "cpu" for o in op.outputs)})
            return self._fail(f"{trace.syncs} synchronizing call(s); ops "
                              f"that sync or reach the host: {suspects}")
        return self._pass(f"0 synchronizing calls in {len(trace.ops)} ops")


class LaunchBudget(Rule):
    """The device kernels of one step stay within ``budget`` (copies and
    sets count too), and each ``exact`` kernel -- matched by a substring
    of its name -- launches exactly that many times: a per-hop loop that
    sneaks back into a one-launch traversal shows here. A card rule."""

    name = "LaunchBudget"
    family = "trace"
    contract = ("one serving step launches at most `budget` device "
                "kernels, and the pinned kernels exactly their count")

    def __init__(self, budget: int, exact: Optional[Dict[str, int]] = None):
        self.budget = int(budget)
        self.exact = dict(exact or {})

    def check(self, trace: StepTrace) -> RuleResult:
        if trace.kernels is None:
            return self._skip(f"{trace.device}: device kernels not counted "
                              "(a CUDA device's torch.profiler counts them; "
                              "on one, a session that lost events at its "
                              "edges three times)")
        n = trace.n_kernels
        problems = []
        if n > self.budget:
            top = sorted(trace.kernels.items(), key=lambda kv: -kv[1])[:6]
            problems.append(f"{n} device kernels over the budget "
                            f"{self.budget} (most: {top})")
        for key, want in self.exact.items():
            got = sum(c for k, c in trace.kernels.items() if key in k)
            if got != want:
                problems.append(f"{key}: {got} launches, not {want}")
        if problems:
            return self._fail("; ".join(problems))
        pinned = "".join(f", {k} x{v}" for k, v in self.exact.items())
        return self._pass(f"{n} device kernels <= {self.budget}{pinned}")


class SwapCase(NamedTuple):
    """The subject of :class:`SwapWithoutCopy`: an engine, the state to
    swap in, and what the caller keeps of the installed state (a model it
    goes on using; nothing else of that state may be held elsewhere)."""

    engine: Any
    new_state: Any
    keep: Any = None


def _storages(leaves) -> Dict[int, int]:
    """{storage data_ptr: nbytes} of the tensors among ``leaves``."""
    out = {}
    for t in leaves:
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            out[s.data_ptr()] = s.nbytes()
    return out


class SwapWithoutCopy(Rule):
    """``ServingEngine.swap(new)`` installs ``new``'s own tensors (every
    leaf's ``data_ptr`` equal), and the old state's tensors that neither
    ``new`` nor the caller's ``keep`` share are freed (weakrefs dead
    after ``gc.collect()``). On a card ``memory_allocated`` then falls by
    at least their bytes: the swap allocated nothing, so what the engine
    holds is back to one state's worth, as before ``new`` was built."""

    name = "SwapWithoutCopy"
    family = "trace"
    contract = ("a swap installs the new state's tensors without a copy "
                "and the displaced state's tensors are freed")

    def check(self, case: SwapCase) -> RuleResult:
        from repro_torch import tree

        engine = case.engine
        cuda = engine.device.type == "cuda"
        new_leaves = [t for t in tree.leaves(case.new_state)
                      if isinstance(t, torch.Tensor)]
        shared = {**_storages(new_leaves),
                  **_storages(t for t in tree.leaves(case.keep))}
        old = [t for t in tree.leaves(engine.state)
               if isinstance(t, torch.Tensor)]
        own = {p: b for p, b in _storages(old).items() if p not in shared}
        refs = [weakref.ref(t) for t in old
                if t.untyped_storage().data_ptr() in own]
        del old
        if cuda:
            torch.cuda.synchronize(engine.device)
            before = torch.cuda.memory_allocated(engine.device)
        engine.swap(case.new_state)
        problems = []
        installed = [t for t in tree.leaves(engine.state)
                     if isinstance(t, torch.Tensor)]
        moved = sum(a.data_ptr() != b.data_ptr()
                    for a, b in zip(installed, new_leaves))
        if len(installed) != len(new_leaves) or moved:
            problems.append(f"{moved} of {len(new_leaves)} installed leaves "
                            "are not the new state's tensors")
        del installed, new_leaves
        gc.collect()
        alive = sum(r() is not None for r in refs)
        if alive:
            problems.append(f"{alive} of {len(refs)} displaced tensors "
                            "still alive after the swap")
        freed = None
        if cuda:
            torch.cuda.synchronize(engine.device)
            freed = before - torch.cuda.memory_allocated(engine.device)
            if freed < sum(own.values()):
                problems.append(f"memory_allocated fell by {freed} B, the "
                                f"displaced state held {sum(own.values())}"
                                " B (the swap allocated, or kept the old "
                                "state)")
        if problems:
            return self._fail("; ".join(problems))
        mem = "" if freed is None else \
            f"; memory_allocated fell by {freed} B"
        return self._pass(f"{len(refs)} displaced tensors freed "
                          f"({sum(own.values())} B), installed leaves are "
                          f"the new state's{mem}")
