"""The run-major ``ivf_scan_topk`` (``csrc/ivf_scan.cu`` on the work-item
scan of ``csrc/ip_scan.cuh``): its runs, its work plan, its plain version,
and on the card its kernel.

On the CPU, on every kind of probe schedule of
``repro_torch.testing.IVF_SCHEDULES`` (whole lists, a pad slot inside a
list, non-contiguous blocks, a tag change inside consecutive blocks, a
duplicated block and list, all pad, M = 0, layout blocks of 256 with
slack blocks):

* ``schedule_runs`` against a slot-by-slot walk of the schedule;
* ``run_plan`` (the device plan in Python: run groups, pieces, items,
  partial slots): every run is scanned once over all its rows, each of
  its pieces in one item of at most ``K.IP_TILE_M`` runs, its slots are
  distinct and a query has at most its valid schedule slots of them (the
  kernel's partial lists are sized by the schedule), items come largest
  piece first; at the main path's shapes about ``PIECES_PER_SM`` items an
  SM; the plan's constants are the kernel source's;
* ``ivf_scan_topk_plain`` against the JAX reference's Pallas kernel in
  interpret mode and its ``ref.py`` at k = 10, 100 and 200, u8 and f32
  codes, from numpy inputs made from a seed; tolerance ``testing.dot_tol``
  (fp32 sums in another order). The reference cannot take M = 0 (its
  oracle reshapes by M), so that case checks the plain version's shapes.

On the card (``cuda`` marker, skipped elsewhere; JAX is imported inside the
CPU tests only, so ``python -m pytest -m cuda tests/test_torch_ivf_runs.py``
runs on a machine without it): the kernel bit for bit on integer data
against ``testing.exact_ivf_topk`` on the same schedules at k in {1, 10,
100, 129, 200}; a tie across two runs; two calls bit-identical; with
the plain version monkeypatched to raise, the wrapper launches its kernel;
no queries and a schedule with no slots.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.ivf_scan import (PIECES_PER_SM, SIZE_BINS,
                                          run_plan, schedule_runs)
from repro_torch.testing import (IVF_SCHEDULES, assert_topk_close, dot_tol,
                                 exact_ivf_topk, ivf_schedule_case)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _norm(a):
    a = np.asarray(a, np.float64)
    if a.size == 0:
        return 0.0
    return float(np.linalg.norm(a.reshape(-1, a.shape[-1]), axis=1).max())


def _walk_runs(sched, tags):
    """Runs by walking each query's slots: [query, slot, first, blocks,
    tag]."""
    nb = len(tags)
    out = []
    for q, row in enumerate(sched.tolist()):
        prev = None
        for s, b in enumerate(row):
            if not 0 <= b < nb:
                prev = None
                continue
            if prev is not None and b == prev + 1 and tags[b] == tags[prev]:
                out[-1][3] += 1
            else:
                out.append([q, s, b, 1, int(tags[b])])
            prev = b
    return out


# ---------------------------------------------------------------------------
# CPU: runs and the work plan.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", IVF_SCHEDULES)
def test_schedule_runs(kind):
    _, _, tags, _, _, sched, _ = ivf_schedule_case(kind, True)
    runs = schedule_runs(_t(sched), _t(tags))
    got = torch.stack([runs.query, runs.slot, runs.first, runs.blocks,
                       runs.tag], 1).tolist() if runs.query.numel() else []
    assert got == _walk_runs(sched, tags)
    if kind == "contiguous":       # each probed list is one run
        valid = [[b for b in row if b >= 0] for row in sched.tolist()]
        lists = sum(len(set(tags[v])) for v in valid)
        assert len(got) == lists
    if kind == "duplicate":        # a block listed twice: two runs
        assert any(r[3] == 1 for r in got)


def _check_plan(sched, tags, lb, n, sms):
    plan = run_plan(_t(sched), _t(tags), lb, n, sms)
    runs = plan.runs
    nr = runs.query.numel()
    m, s = sched.shape
    gb, gp = plan.group_blocks.tolist(), plan.group_pieces.tolist()
    first, blocks = runs.first.tolist(), runs.blocks.tolist()
    query = runs.query.tolist()
    pieces = {r: [] for r in range(nr)}
    sizes = []
    for g, idx, j in plan.items:
        idx = idx.tolist()
        assert 1 <= len(idx) <= K.IP_TILE_M
        bs, be = gb[g] * j // gp[g], gb[g] * (j + 1) // gp[g]
        sizes.append(min(be - bs, SIZE_BINS - 1))
        for r in idx:
            assert first[r] == g
            pieces[r].append((bs, be, j))
    assert sizes == sorted(sizes, reverse=True)
    assert sum(plan.group_count.tolist()) == nr
    slots = {q: [] for q in range(m)}
    for r in range(nr):
        # every piece of b0 once; those that start inside the run cover
        # its blocks exactly
        assert sorted(p[2] for p in pieces[r]) == list(range(gp[first[r]]))
        mine = sorted(p for p in pieces[r] if p[0] < blocks[r])
        assert mine[0][0] == 0 and mine[-1][1] >= blocks[r]
        assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
        assert len(mine) == -(-blocks[r] * gp[first[r]] // gb[first[r]])
        slots[query[r]] += [int(plan.run_slot[r]) + p[2] for p in mine]
    valid = ((sched >= 0) & (sched < len(tags))).sum(1)
    for q in range(m):
        assert sorted(slots[q]) == list(range(int(plan.nslots[q])))
        assert int(plan.nslots[q]) <= valid[q] <= s
    return plan


@pytest.mark.parametrize("kind", IVF_SCHEDULES)
def test_run_plan_scans_every_run_once(kind):
    """On two SMs the tiny schedules are cut into pieces of a block or
    two; on 132 the same invariants hold."""
    _, _, tags, _, codes, sched, lb = ivf_schedule_case(kind, True)
    for sms in (2, 132):
        _check_plan(sched, tags, lb, codes.shape[0], sms)


def test_run_plan_at_the_main_path_shape():
    """48 lists of 3 to 19 layout blocks of 4096 rows, 1024 queries
    probing 12 (skewed towards the first lists), on 132 SMs: about
    PIECES_PER_SM items an SM, each query's slots at most its valid
    slots, and the largest pieces first."""
    rng = np.random.default_rng(7)
    c, lb, m, nprobe = 48, 4096, 1024, 12
    sizes = rng.integers(3, 20, c)
    tags = np.repeat(np.arange(c), sizes).astype(np.int32)
    ends = np.cumsum(sizes)
    maxb = int(sizes.max())
    ranges = np.full((c, maxb), -1, np.int32)
    for t in range(c):
        ranges[t, :sizes[t]] = np.arange(ends[t] - sizes[t], ends[t])
    p = 1.0 / np.arange(1, c + 1)
    probe = np.stack([rng.choice(c, nprobe, replace=False, p=p / p.sum())
                      for _ in range(m)])
    sched = ranges[probe].reshape(m, -1)
    plan = _check_plan(sched, tags, lb, tags.size * lb, 132)
    assert plan.runs.query.numel() == m * nprobe      # a list = a run
    assert 2 * 132 <= len(plan.items) <= 4 * PIECES_PER_SM * 132
    assert int(plan.nslots.max()) <= 4 * nprobe


def test_plan_constants_match_the_kernel_source():
    src = (CSRC / "ivf_scan.cu").read_text()
    found = {name: int(v) for name, v in re.findall(
        r"constexpr int (IVF_PIECES_PER_SM|IVF_SIZE_BINS) = (\d+);", src)}
    assert found == {"IVF_PIECES_PER_SM": PIECES_PER_SM,
                     "IVF_SIZE_BINS": SIZE_BINS}


# ---------------------------------------------------------------------------
# CPU: the plain version against the JAX reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("k", [10, 100, 200])
@pytest.mark.parametrize("kind", IVF_SCHEDULES)
def test_plain_matches_pallas_and_ref(kind, k, u8):
    import jax.numpy as jnp

    from repro.kernels import ivf_scan_topk, ivf_scan_topk_ref

    args = ivf_schedule_case(kind, u8, seed=k)
    q_scaled, q_lo, tags, row_ids, codes, sched, lb = args
    port = K.ivf_scan_topk(*(_t(a) for a in args[:6]), k, lb)   # CPU: plain
    assert port[0].dtype == torch.float32 and port[1].dtype == torch.int32
    assert port[0].shape == port[1].shape == (sched.shape[0], k)
    if kind == "no_queries":
        return
    tol = dot_tol(_norm(q_scaled), _norm(codes), codes.shape[1],
                  float(np.abs(q_lo).max()))
    jargs = tuple(jnp.asarray(a) for a in args[:6])
    pallas = ivf_scan_topk(*jargs, k, layout_block=lb, interpret=True)
    ref = ivf_scan_topk_ref(*jargs, k, layout_block=lb)
    for other, label in ((pallas, "plain vs pallas"), (ref, "plain vs ref")):
        assert_topk_close(port, other, tol, f"{kind} {label}")
        np.testing.assert_array_equal(port[1].numpy() < 0,
                                      np.asarray(other[1]) < 0, label)
    ids = port[1].numpy()
    if sched.shape[0] > 1:
        assert (ids[1] == -1).all()                     # the all-pad query
    if kind == "duplicate":     # the twice-listed list's rows come twice
        live = ids[0][ids[0] >= 0]
        assert len(live) > len(set(live.tolist()))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("kind", IVF_SCHEDULES)
def test_cuda_exact_on_integer_data(cuda, kind, u8):
    args = ivf_schedule_case(kind, u8, integer=True)
    lb = args[6]
    t = [_t(a, cuda) for a in args[:6]]
    for k in (1, 10, 100, 129, 200):
        got = K.ivf_scan_topk(*t, k, lb)
        want = exact_ivf_topk(*t, k, lb)
        assert torch.equal(got[0], want[0]), (kind, k)
        assert torch.equal(got[1], want[1]), (kind, k)


@pytest.mark.cuda
def test_cuda_tie_across_two_runs(cuda):
    """Identical rows in two runs of one query (two lists): equal scores
    come out in ascending id order across the runs."""
    lb, d = 64, 16
    tags = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32, device=cuda)
    codes = torch.ones((5 * lb, d), device=cuda)
    row_ids = torch.randperm(5 * lb, device=cuda).to(torch.int32)
    q = torch.ones((2, 2, d), device=cuda)
    qlo = torch.zeros((2, 2), device=cuda)
    sched = torch.tensor([[0, 1, 2, 3, 4], [2, 3, -1, 0, 1]],
                         dtype=torch.int32, device=cuda)
    for k in (100, 200):
        vals, ids = K.ivf_scan_topk(q, qlo, tags, row_ids, codes, sched, k,
                                    lb)
        for r, blocks in enumerate((5, 4)):     # query 1 skips block 4
            want = torch.sort(row_ids[:blocks * lb]).values[:k]
            assert torch.equal(ids[r], want)
        assert bool((vals == d).all())


@pytest.mark.cuda
def test_cuda_deterministic(cuda):
    for kind in ("contiguous", "duplicate", "slack_256"):
        args = ivf_schedule_case(kind, False, seed=3)
        t = [_t(a, cuda) for a in args[:6]]
        first = K.ivf_scan_topk(*t, 100, args[6])
        again = K.ivf_scan_topk(*t, 100, args[6])
        assert torch.equal(first[0], again[0])
        assert torch.equal(first[1], again[1])


@pytest.mark.cuda
def test_cuda_never_takes_the_plain_path(cuda, monkeypatch):
    ivs = importlib.import_module("repro_torch.kernels.ivf_scan")
    args = ivf_schedule_case("contiguous", True, seed=5)
    t = [_t(a, cuda) for a in args[:6]]
    want = ivs.ivf_scan_topk_plain(*t, 100, args[6])

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")
    monkeypatch.setattr(ivs, "ivf_scan_topk_plain", refuse)
    before = K.ivf_scan_topk.launches
    got = K.ivf_scan_topk(*t, 100, args[6])
    assert K.ivf_scan_topk.launches == before + 1
    tol = dot_tol(_norm(args[0]), _norm(args[4]), args[4].shape[1],
                  float(np.abs(args[1]).max()))
    assert_topk_close(got, want, tol, "kernel vs plain")


@pytest.mark.cuda
def test_cuda_empty_and_zero_width_schedules(cuda):
    """No queries, and a schedule with no slots: the kernel returns the
    right shapes, and (-inf, -1) everywhere for the empty schedule."""
    args = ivf_schedule_case("contiguous", True, seed=2)
    t = [_t(a, cuda) for a in args[:6]]
    vals, ids = K.ivf_scan_topk(*t[:5], t[5][:, :0].contiguous(), 150,
                                args[6])
    assert vals.shape == ids.shape == (t[5].shape[0], 150)
    assert bool((ids == -1).all()) and bool((vals < -1e37).all())
    none = [x[:0].contiguous() for x in t[:2]] + t[2:5] + [t[5][:0]]
    vals, ids = K.ivf_scan_topk(*none, 10, args[6])
    assert vals.shape == ids.shape == (0, 10)
