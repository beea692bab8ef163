"""The fused graph traversal in one launch: ``graph_beam_search`` (CUDA
kernel ``graph_search_kernel`` in ``csrc/graph_scan.cu``), its plain
version and its lowering (``kernels.scorer_beam_search``), which a fused
``GraphIndex`` runs in place of the per-hop loop.

On the CPU (the port alone):

* ``graph_beam_search_plain`` -- the kernel's algorithm: a query stops on
  its own, picks the first ``expand`` expandable slots of a beam sorted
  best first, and carries its visited flags with its entries -- against
  the per-hop loop (``graph._beam_loop`` with ``graph.fused_hop_step``,
  whose hops run ``graph_scan_beam_step_plain`` here): beams (values and
  ids) and hop counts EQUAL, for both sorted scorers, expand 1 and 4, ID
  and OOD queries, a ``max_hops`` cap that every query hits, queries that
  finish many hops apart, -1-padded entries, and dead rows and a dead entry
  after ``remove_rows``;
* the wrapper on CPU tensors takes the plain version and counts no launch;
  ``max_hops = 0`` returns the entry beam; bad arguments raise.

On the CPU against the JAX reference (JAX imported inside these tests):
the wrapper, through the port's fused ``_beam_qstate``, against the
reference's fused traversal (``repro.index.graph``, its hops through the
reference's scorer ``scan_neighbors`` as ``tests/test_torch_graph.py`` runs
them) on the same graph and scorer carried across with
``repro_torch.convert``: ids within ``testing.assert_topk_close`` at
``testing.dot_tol`` (fp32 sums in another order), hop counts equal.

On the card (``cuda`` marker, skipped elsewhere): a fused
``GraphIndex.candidates`` launches ``graph_beam_search`` once and
``graph_scan_beam_step`` never, makes no host sync
(``torch.cuda.set_sync_debug_mode("error")``), and returns exactly what
the per-hop loop over the ``graph_scan_beam_step`` kernel returns; a
gathered scorer's search (five modes) is one launch with no host sync and
agrees with its per-hop loop; the kernel equals its plain version bit for
bit on integer data.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import gleanvec as gv
from repro_torch.core import scorer as sc
from repro_torch.data import vectors
from repro_torch.index import graph
from repro_torch.index.topk import NEG_INF

N, D, C, DLOW, BLOCK, BEAM, NQ = 3000, 32, 6, 8, 64, 32, 24


@pytest.fixture(scope="module")
def world():
    ds = vectors.make_dataset("graph-search", n=N, d=D, n_queries=64,
                              ood=True, seed=3)
    x = torch.as_tensor(ds.database)
    g = torch.Generator().manual_seed(0)
    model = gv.fit(torch.as_tensor(ds.queries_learn), x, c=C, d=DLOW,
                   kmeans_iters=4, generator=g, device="cpu")
    scorers = {
        "gleanvec-sorted": sc.sorted_gleanvec_scorer(model, x, block=BLOCK),
        "gleanvec-int8-sorted": sc.sorted_gleanvec_quantized_scorer(
            model, x, block=BLOCK)}
    gi = graph.build(ds.database, r=12, n_iters=3, seed=0, device="cpu")
    queries = {"id": x[:NQ] + 0.01,
               "ood": torch.as_tensor(ds.queries_test[:NQ])}
    return scorers, gi, queries


def _per_hop(qstate, scorer, fg, beam, hops, expand):
    """The per-hop loop: (vals, ids, hops), the beam best first."""
    m = (qstate.q_scaled if isinstance(qstate, tuple) else qstate).shape[0]
    step = graph.fused_hop_step(qstate, scorer, fg, beam, expand)
    vals, ids, n, _ = graph._beam_loop(graph._score_ids_of(qstate, scorer),
                                       fg, m, beam, hops, expand,
                                       fused_step=step)
    return vals, ids, n


def _one_launch(qstate, scorer, fg, beam, hops, expand):
    """The traversal as ``_beam_qstate`` lowers it: (vals, ids, hops (m,))."""
    m = (qstate.q_scaled if isinstance(qstate, tuple) else qstate).shape[0]
    bv, bi = graph._entry_beam(graph._score_ids_of(qstate, scorer), fg, m,
                               beam)
    return K.scorer_beam_search(scorer, qstate, fg.nbr_rows, bv, bi, hops,
                                expand)


def _check_equal(scorer, fg, qstate, beam, hops, expand):
    got = _one_launch(qstate, scorer, fg, beam, hops, expand)
    want = _per_hop(qstate, scorer, fg, beam, hops, expand)
    assert int(got[2].max()) == want[2] > 0
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return got


@pytest.mark.parametrize("qkind", ["id", "ood"])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("mode", ["gleanvec-sorted", "gleanvec-int8-sorted"])
def test_plain_traversal_equals_per_hop_loop(world, mode, expand, qkind):
    scorers, gi, queries = world
    s = scorers[mode]
    fg = dataclasses.replace(graph.with_fused_scan(gi, s), beam=BEAM,
                             expand=expand)
    qstate = s.prepare_queries(queries[qkind])
    got = _check_equal(s, fg, qstate, BEAM, 256, expand)
    # every query stops on its own: the counts spread over many hops
    h = got[2]
    assert int(h.max()) - int(h.min()) >= 3, h.tolist()
    # the public path returns the same top-k and the most hops
    top = graph._beam_qstate(qstate, s, fg, 10, BEAM, 256, expand=expand)
    sel = graph._best_slots(got[0], 10)
    assert torch.equal(top[0], torch.gather(got[0], 1, sel))
    assert torch.equal(top[1], torch.gather(got[1], 1, sel))
    assert int(top[2]) == int(h.max())


@pytest.mark.parametrize("expand", [1, 4])
def test_max_hops_cap(world, expand):
    """A cap that every query hits: each query's count is the cap, and the
    beams equal the loop's cut at the same hop."""
    scorers, gi, queries = world
    s = scorers["gleanvec-int8-sorted"]
    fg = dataclasses.replace(graph.with_fused_scan(gi, s), beam=BEAM,
                             expand=expand)
    qstate = s.prepare_queries(queries["ood"])
    got = _check_equal(s, fg, qstate, BEAM, 3, expand)
    assert bool((got[2] == 3).all())


def test_padded_entries_and_a_wide_beam(world):
    """-1-padded entry points never enter the beam; a beam wider than the
    graph's reach ends with -1 slots at NEG_INF."""
    scorers, gi, queries = world
    s = scorers["gleanvec-sorted"]
    pad = torch.full((3,), -1, dtype=gi.entries.dtype)
    g2 = dataclasses.replace(gi, entries=torch.cat([pad, gi.entries[:5],
                                                    pad]))
    fg = graph.with_fused_scan(g2, s)
    qstate = s.prepare_queries(queries["id"])
    for beam, expand in ((BEAM, 4), (96, 1)):
        got = _check_equal(s, fg, qstate, beam, 256, expand)
        assert not bool((got[1] < 0).all())
        assert bool(((got[1] >= 0) | (got[0] == NEG_INF)).all())


@pytest.mark.parametrize("expand", [1, 4])
def test_dead_rows_and_a_dead_entry(world, expand):
    """``remove_rows`` on the sorted scorer, the fused graph re-derived:
    removed ids never come back, an entry point that was removed scores
    NEG_INF yet stays expandable (as in the loop), and the traversal equals
    the per-hop loop."""
    scorers, gi, queries = world
    for mode in ("gleanvec-sorted", "gleanvec-int8-sorted"):
        s = scorers[mode]
        rm = torch.cat([gi.entries[:1].to(torch.int64),
                        torch.arange(5, N, 11)]).to(torch.int32)
        s2 = s.remove_rows(rm)
        fg = dataclasses.replace(graph.with_fused_scan(gi, s2), beam=BEAM,
                                 expand=expand)
        qstate = s2.prepare_queries(queries["ood"])
        got = _check_equal(s2, fg, qstate, BEAM, 256, expand)
        live = got[1][got[0] > NEG_INF]
        assert not bool(torch.isin(live, rm).any())


def test_wrapper_takes_plain_on_cpu_and_counts_nothing(world):
    scorers, gi, queries = world
    s = scorers["gleanvec-int8-sorted"]
    fg = graph.with_fused_scan(gi, s)
    qstate = s.prepare_queries(queries["id"])
    bv, bi = graph._entry_beam(graph._score_ids_of(qstate, s), fg, NQ, BEAM)
    args = (qstate.q_scaled, qstate.q_lo, s.block_tags, s.perm, s.codes,
            fg.nbr_rows, bv, bi)
    before = (K.graph_beam_search.launches, K.graph_scan_beam_step.launches)
    got = K.graph_beam_search(*args, layout_block=s.layout_block,
                              max_hops=50, expand=4)
    want = K.graph_beam_search_plain(*args, layout_block=s.layout_block,
                                     max_hops=50, expand=4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (K.graph_beam_search.launches,
            K.graph_scan_beam_step.launches) == before
    zero = K.graph_beam_search(*args, layout_block=s.layout_block,
                               max_hops=0, expand=4)
    assert torch.equal(zero[0], bv) and torch.equal(zero[1], bi)
    assert not bool(zero[2].any())
    with pytest.raises(ValueError, match="expand"):
        K.graph_beam_search(*args, layout_block=s.layout_block, max_hops=5,
                            expand=BEAM + 1)
    with pytest.raises(ValueError, match="max_hops"):
        K.graph_beam_search(*args, layout_block=s.layout_block, max_hops=-1,
                            expand=1)
    # every scorer class of the port has a lowering (the gathered ones
    # over the id table); anything else, here a graph, is refused
    with pytest.raises(TypeError, match="beam_search"):
        K.scorer_beam_search(gi, None, None, None, None, 1, 1)


# ---------------------------------------------------------------------------
# Against the JAX reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,expand", [("gleanvec-int8-sorted", 4),
                                         ("gleanvec-sorted", 1)])
def test_wrapper_matches_reference_traversal(mode, expand):
    import jax
    import jax.numpy as jnp

    from repro.core import gleanvec as rgv
    from repro.core import scorer as rsc
    from repro.data import vectors as rvectors
    from repro.index import graph as rgraph
    from repro.index.protocol import replace as rreplace
    from repro_torch import convert
    from repro_torch.testing import assert_topk_close, dot_tol

    ds = rvectors.make_dataset("graph-search-ref", n=1500, d=32,
                               n_queries=32, ood=True, seed=9)
    xj = jnp.asarray(ds.database)
    model = rgv.fit(jax.random.PRNGKey(0), jnp.asarray(ds.queries_learn), xj,
                    c=4, d=8)
    rs = rsc.build_scorer(mode, xj, model, block=64)
    ps = convert.scorer(type(rs).__name__, convert.arrays_of(rs), "cpu")
    rg = rreplace(rgraph.build(ds.database, r=12, n_iters=3, seed=0),
                  beam=BEAM, max_hops=128, expand=expand)
    rg = rgraph.with_fused_scan(rg, rs)
    pg = convert.graph_index(rg, "cpu")
    q = ds.queries_test[:16]
    want = rgraph._beam_qstate(rs.prepare_queries(jnp.asarray(q)), rs, rg,
                               10, BEAM, 128, expand=expand)
    pq = ps.prepare_queries(torch.as_tensor(q))
    before = K.graph_beam_search.launches
    got = graph._beam_qstate(pq, ps, pg, 10, BEAM, 128, expand=expand)
    assert K.graph_beam_search.launches == before        # CPU: plain
    assert int(got[2]) == int(want[2]) > 0
    qs, lo = (pq.q_scaled, float(pq.q_lo.abs().max())) \
        if isinstance(pq, tuple) else (pq, 0.0)
    rows = ps.codes if hasattr(ps, "codes") else ps.x_low
    tol = dot_tol(float(qs.norm(dim=-1).max()),
                  float(rows.float().norm(dim=1).max()), rows.shape[1], lo)
    assert_topk_close(got[:2], tuple(np.asarray(w) for w in want[:2]), tol,
                      f"{mode} expand={expand}")


# ---------------------------------------------------------------------------
# The card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("expand", [1, 4])
def test_cuda_fused_candidates_one_launch_no_sync(cuda, expand,
                                                   monkeypatch):
    import repro_torch.kernels.graph_scan as gs
    g = torch.Generator(device=cuda).manual_seed(expand)
    x = torch.randn(4000, 32, device=cuda, generator=g)
    q = torch.randn(300, 32, device=cuda, generator=g)
    model = gv.fit(q, x, c=6, d=16, kmeans_iters=4, generator=g, device=cuda)
    for s in (sc.sorted_gleanvec_scorer(model, x, block=64),
              sc.sorted_gleanvec_quantized_scorer(model, x, block=64)):
        fg = dataclasses.replace(
            graph.with_fused_scan(graph.build(x, r=12, n_iters=2,
                                              device=cuda), s),
            beam=64, max_hops=200, expand=expand)
        qstate = s.prepare_queries(q)
        want = _per_hop(qstate, s, fg, 64, 200, expand)

        def refuse(*a, **k):
            raise AssertionError("plain path taken for a CUDA tensor")

        monkeypatch.setattr(gs, "graph_beam_search_plain", refuse)
        monkeypatch.setattr(gs, "graph_scan_beam_step_plain", refuse)
        before = (K.graph_beam_search.launches,
                  K.graph_scan_beam_step.launches)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            top, ids = fg.candidates(qstate, s, 64)
            hops = graph._beam_qstate(qstate, s, fg, 64, 64, 200,
                                      expand=expand)[2]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        monkeypatch.undo()
        assert (K.graph_beam_search.launches,
                K.graph_scan_beam_step.launches) == \
            (before[0] + 2, before[1])
        sel = graph._best_slots(want[0], 64)
        assert torch.equal(top, torch.gather(want[0], 1, sel))
        want_ids = torch.gather(want[1], 1, sel)
        assert torch.equal(ids, torch.where(top > NEG_INF, want_ids,
                                            torch.full_like(want_ids, -1)))
        assert int(hops) == want[2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "sphering", "gleanvec",
                                  "sphering-int8", "gleanvec-int8"])
def test_cuda_gathered_candidates_one_launch_no_sync(cuda, mode):
    """A gathered scorer over a graph that is not fused: one
    ``graph_beam_search`` launch a search at layout block 1, no host sync,
    and the per-hop loop's beams (within ``testing.dot_tol``: the kernel
    sums each score in another order)."""
    from repro_torch.core import leanvec_sphering as lvs
    from repro_torch.testing import topk_agreement
    g = torch.Generator(device=cuda).manual_seed(len(mode))
    x = torch.randn(4000, 32, device=cuda, generator=g)
    q = torch.randn(300, 32, device=cuda, generator=g)
    model = (None if mode == "full" else
             lvs.fit(q, x, 16) if mode.startswith("sphering")
             else gv.fit(q, x, c=6, d=16, kmeans_iters=4, generator=g,
                         device=cuda))
    s = sc.build_scorer(mode, x, model, device=cuda)
    gi = dataclasses.replace(graph.build(x, r=12, n_iters=2, device=cuda),
                             beam=64, max_hops=200, expand=4)
    qstate = s.prepare_queries(q)
    loop = graph._beam_loop(graph._score_ids_of(qstate, s), gi, 300, 64,
                            200, 4)
    before = K.graph_beam_search.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = graph._beam_qstate(qstate, s, gi, 64, 64, 200, expand=4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert K.graph_beam_search.launches == before + 1
    assert topk_agreement(got[:2], loop[:2], 1e-4)["id_agreement"] >= 0.99
    assert abs(int(got[2]) - loop[2]) <= 2 and loop[2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("expand", [1, 4])
def test_cuda_kernel_equals_plain_on_integer_data(cuda, u8, expand):
    g = torch.Generator(device=cuda).manual_seed(2 * expand + u8)
    m, c, d, lb, nb, r, b = 70, 5, 40 if u8 else 33, 64, 40, 20, 96
    n = lb * nb

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=cuda)

    codes = ints(0, 4, n, d)
    codes = codes.to(torch.uint8) if u8 else codes.float() - 2
    rid = torch.randperm(n, generator=g, device=cuda).to(torch.int32)
    rid[::9] = -1
    tbl = ints(-3, n, n, r).clamp(min=-1).to(torch.int32)
    bi = torch.full((m, b), -1, dtype=torch.int32, device=cuda)
    bi[:, :12] = torch.randperm(n, generator=g, device=cuda)[:12].to(
        torch.int32)
    bv = torch.where(bi >= 0, ints(-300, 301, m, b).float(),
                     torch.full((m, b), NEG_INF, device=cuda))
    args = (ints(-3, 4, m, c, d).float(), ints(-40, 41, m, c).float(),
            ints(0, c, nb).to(torch.int32), rid, codes, tbl, bv, bi)
    for hops in (200, 4):
        got = K.graph_beam_search(*args, layout_block=lb, max_hops=hops,
                                  expand=expand)
        want = K.graph_beam_search_plain(*args, layout_block=lb,
                                         max_hops=hops, expand=expand)
        for a, w in zip(got, want):
            assert torch.equal(a, w), hops
