"""The dry run (``repro_torch/launch/dryrun.py``) and its report.

Part 1, against the reference: one smoke cell of each family on the
one-device host mesh. The port's ``argument_bytes`` (from the specs)
equals the reference's compiled ``memory_analysis().argument_size_in_bytes``
exactly (``jax.jit(keep_unused=True)``: the reference's serve steps leave
their batch's labels unused, and XLA would otherwise drop them), and the
port's matmul flops (traced on fake tensors) equal
``hlo_analysis.analyze_hlo(...)["dot_flops"]`` within 1e-6 relative, after
one named correction: the LM prefill's attention. The port's
``flash_attention`` kernel counts 4 dh flops an unmasked (query, key)
pair; the reference's attention multiplies every (query, key) pair of the
S x S square and masks after (its smoke prefill reads 16 % more dot flops
at S 64, window 16). The reference's compiles run in a process of their
own with one XLA thread.

Part 2: every non-skipped cell of the registry at smoke size on a fake
4-rank (2, 2) ("data", "model") group gives an ``ok`` record; the
``vs_*`` cells are traced per device (collectives over the group seen),
the others ideal; ``report.py``'s tables equal the reference's
``dryrun_table`` / ``roofline_table`` on the same rows, apart from the
fits column (80 GB here, 16 GB there), the trace time in the reference's
compile-time column, and the roofline's added ``split``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention import attention_pairs
from repro_torch.launch import dryrun, report
from repro_torch.launch import mesh as mesh_mod

ROOT = Path(__file__).resolve().parents[1]
FAMILY_CELLS = [("gleanvec-paper", "search_oi13m"),
                ("h2o-danube-3-4b", "prefill_32k"),
                ("dlrm-mlperf", "serve_p99"),
                ("gcn-cora", "full_graph_sm")]
FLOP_RTOL = 1e-6
GRID = mesh_mod.Mesh(("data", "model"), (2, 2))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_cells():
    """{cell: (argument_size_in_bytes, dot_flops)} of the reference's
    compiled smoke bundles on its host mesh."""
    code = textwrap.dedent(f"""
        import json
        import jax
        from repro.launch import steps
        from repro.launch.mesh import make_host_mesh
        from repro.utils import hlo_analysis
        out = {{}}
        for arch, shape in {FAMILY_CELLS!r}:
            b = steps.build_bundle(arch, shape, make_host_mesh(), smoke=True)
            c = jax.jit(b.fn, keep_unused=True).lower(*b.args).compile()
            st = hlo_analysis.analyze_hlo(c.as_text(),
                                          default_trips=b.trip_counts)
            out[f"{{arch}}:{{shape}}"] = (
                c.memory_analysis().argument_size_in_bytes, st["dot_flops"])
        print(json.dumps(out))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_smoke_cell_matches_the_reference(arch, shape, reference_cells):
    from repro_torch.launch import steps
    rec = dryrun.run_cell(arch, shape, "host", smoke=True, device="cpu",
                          mesh=mesh_mod.Mesh(("data",), (1,)))
    want_args, want_flops = reference_cells[f"{arch}:{shape}"]
    assert rec["ok"] and rec["split"] == "traced" and rec["n_chips"] == 1
    assert rec["memory"]["argument_bytes"] == want_args
    flops = rec["cost"]["flops"]
    if shape == "prefill_32k":
        # the reference's dense S x S attention products (see the
        # module's docstring)
        b = steps.build_bundle(arch, shape, smoke=True, device="cpu")
        c, (nb, s) = b.config, b.args[1].shape
        flops += 4 * c.d_head * nb * c.n_heads * c.n_layers * (
            s * s - attention_pairs(s, True, c.swa_window))
    assert flops == pytest.approx(want_flops, rel=FLOP_RTOL)
    assert rec["roofline"]["hlo_flops"] == rec["cost"]["flops"]
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]


@pytest.fixture(scope="module")
def grid_records():
    return {}


@pytest.mark.parametrize("arch,shape", dryrun.all_cells(),
                         ids=lambda v: str(v))
def test_every_cell_traces_on_a_fake_group(arch, shape, grid_records):
    import torch.distributed as dist
    rec = dryrun.run_cell(arch, shape, "grid", smoke=True, device="cpu",
                          mesh=GRID)
    assert not (dist.is_available() and dist.is_initialized())
    grid_records[(arch, shape)] = rec
    assert rec["ok"] and rec["n_chips"] == 4
    mem, cost = rec["memory"], rec["cost"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["peak_bytes"] >= mem["argument_bytes"] and mem["fits_h100_80g"]
    assert cost["flops"] >= 0 and cost["bytes_written"] > 0
    assert rec["roofline"]["bound_s"] > 0
    if arch == "gleanvec-paper":
        # each rank's blocks over the group: the moments' all-reduces or
        # the candidates' all-gathers, among 4 ranks (one node)
        assert rec["split"] == "traced" and rec["collectives"]["count"] > 0
        assert all(g["link"] == "nvlink" and g["n_ranks"] > 1
                   for g in rec["collectives"]["groups"])
    else:
        assert rec["split"] == "ideal" and rec["collectives"]["bytes"] == 0


def test_search_cell_is_per_device(grid_records):
    """The traced search step reads a quarter of the rows a rank: its
    argument bytes and B1 flops are those of its local blocks."""
    rec = dryrun.run_cell("gleanvec-paper", "search_oi13m", "grid",
                          smoke=True, device="cpu", mesh=GRID)
    one = dryrun.run_cell("gleanvec-paper", "search_oi13m", "host",
                          smoke=True, device="cpu",
                          mesh=mesh_mod.Mesh(("data",), (1,)))
    from repro_torch.launch import steps
    b = steps.build_bundle("gleanvec-paper", "search_oi13m", smoke=True,
                           device="cpu", mesh=GRID)
    q, tags, x_low, x_full, a = b.args
    nbytes = (q.numel() + a.numel()) * 4 + (
        tags.numel() * 4 + (x_low.numel() + x_full.numel()) * 4) // 4
    assert rec["memory"]["argument_bytes"] == nbytes
    m, n, d = q.shape[0], x_low.shape[0], x_low.shape[1]
    # rows pad to 4096 a shard: a rank's quarter of the grid's rows is the
    # one-device step's whole database, and so are its products
    host = steps.build_bundle("gleanvec-paper", "search_oi13m", smoke=True,
                              device="cpu")
    assert host.args[2].shape[0] == n // 4
    assert rec["cost"]["flops"] == one["cost"]["flops"]
    assert rec["cost"]["flops"] >= 2 * m * (n // 4) * d


def _as_reference(rec):
    rec = json.loads(json.dumps(rec))
    rec["compile_s"] = rec["trace_s"]
    rec["memory"]["fits_v5e_16g"] = rec["memory"]["fits_h100_80g"]
    return rec


def test_report_tables_match_the_reference(tmp_path):
    from repro.launch import report as ref_report
    cells = [("gleanvec-paper", "search_oi13m_sorted"),
             ("fm", "serve_p99"), ("gcn-cora", "molecule")]
    for arch, shape in cells:
        rec = dryrun.run_cell(arch, shape, "grid", smoke=True, device="cpu",
                              mesh=GRID)
        (tmp_path / f"{arch}__{shape}__grid.json").write_text(
            json.dumps(rec))
    rows = report.load("grid", results_dir=str(tmp_path))
    assert [(r["arch"], r["shape"]) for r in rows] == sorted(cells)
    got = report.dryrun_table(rows).splitlines()
    want = ref_report.dryrun_table([_as_reference(r) for r in rows]
                                   ).splitlines()
    assert got[0].replace("trace s", "compile s").replace(
        "fits 80G", "fits 16G").replace("GFLOP/dev", "HLO GFLOP/dev") \
        == want[0]
    assert got[1:] == want[1:]
    got = report.roofline_table(rows).splitlines()
    want = ref_report.roofline_table([_as_reference(r) for r in rows]
                                     ).splitlines()

    def drop_split(line):
        cols = line.split(" | ")
        return " | ".join(cols[:2] + cols[3:])
    assert [drop_split(x) for x in got[2:]] == want[2:]
    assert got[0].replace(" split |", "") == want[0]
    assert all(" ideal " in x or " traced " in x for x in got[2:])


def test_step_on_given_arguments_counts_their_bytes():
    """As ``chip_smoke.py``'s phase 3p reads a measured step: a bundle
    without specs, traced at its arguments' shapes on one device, counts
    exactly their bytes; a decode step's cache comes back updated in place
    (an output that is an argument: ``alias_bytes``)."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    b = steps.build_bundle("h2o-danube-3-4b", "decode_32k", smoke=True,
                           device="cpu")
    cfg = b.config
    args = (tfm.init(cfg, device="cpu"),
            tfm.init_cache(cfg, 4, 64, device="cpu"),
            torch.zeros(4, dtype=torch.int32),
            torch.tensor(63, dtype=torch.int32))
    leaves = [t for t in torch.utils._pytree.tree_leaves(args)]
    meta = torch.utils._pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), args)
    trace = dryrun.trace_step(b.fn, meta, device="cpu")
    one = mesh_mod.Mesh(("data",), (1,))
    rec = dryrun.record_of("h2o-danube-3-4b", "decode", "one",
                           steps.StepBundle(name="decode", fn=b.fn,
                                            args=meta, config=cfg,
                                            device=torch.device("cpu")),
                           one, trace, "traced")
    mem = rec["memory"]
    assert mem["argument_bytes"] == sum(t.numel() * t.element_size()
                                        for t in leaves)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in torch.utils._pytree.tree_leaves(args[1]))
    assert mem["alias_bytes"] == cache_bytes
    assert mem["output_bytes"] == cache_bytes + 4 * cfg.vocab * 4
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"] \
        + mem["output_bytes"] - mem["alias_bytes"]


def test_in_place_writes_count_their_slice():
    """As the reference's ``test_dus_counted_at_slice_size``: 100 writes
    of a (128, 128) f32 slice into a (100, 128, 128) stack count 100
    slices, not 100 stacks, whether through a view's ``copy_``,
    ``index_copy_`` or ``index_put_``; a view writes nothing."""
    slice_bytes = 128 * 128 * 4

    def step(stack, x):
        for i in range(100):
            stack[i] = x                                # copy_ into a view
        idx = torch.arange(100)
        stack.index_copy_(0, idx[:1], x[None])
        stack.index_put_((idx[:1],), x[None])
        return stack.view(100, -1)                      # a view: nothing

    meta = (torch.empty(100, 128, 128, device="meta"),
            torch.empty(128, 128, device="meta"))
    trace = dryrun.trace_step(step, meta, device="cpu")
    # the slices, and the 100 int64 indices made once
    assert trace["write_bytes"] == 102 * slice_bytes + 100 * 8
    assert trace["alias_bytes"] == 100 * slice_bytes
    assert trace["temp_peak_bytes"] == 100 * 8
