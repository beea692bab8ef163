"""The gathered graph traversal in one launch: the four gathered scorer
classes (``LinearScorer`` for "full" and "sphering", ``QuantizedScorer``,
``GleanVecScorer``, ``GleanVecQuantizedScorer``) lowered by
``kernels.scorer_beam_search`` to ``graph_beam_search`` over the graph's id
table at layout block 1 (rows are ids; a removed id's row reads -1).

On the CPU, for each of the five gathered modes, expand 1 and 4:

* the one-launch lowering (``graph_beam_search_plain`` here) against the
  per-hop loop (``graph._beam_loop`` with ``graph.gathered_beam_step``):
  candidates within ``testing.assert_topk_close`` at ``testing.dot_tol``
  (the kernel's scores are the same f32 dot products summed in another
  order), hop counts equal; ``_beam_qstate`` takes the one launch (the
  plain version once, the per-hop loop never) and the tag trace still
  takes the loop;
* the same against the reference's ``repro.index.graph.beam_search_scorer``
  (and its ``_beam_qstate``'s hop count) on the same numpy inputs, with
  the reference's graph and scorer carried across by ``repro_torch.convert``;
* one stream cycle (``with_capacity`` + ``insert_ids`` + ``remove_rows``):
  the graph's ids still equal the store's rows, removed ids read -1 in the
  lowering's ``row_ids``, none is returned, and the one launch agrees with
  the loop and with the reference's churned traversal;
* the lowering's layout cache under a stream of removes: one entry a store
  tensor, always the newest live mask's.

JAX is imported only inside these tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gleanvec as rgv
from repro.core import leanvec_sphering as rlvs
from repro.core import scorer as rsc
from repro.core import streaming as rst
from repro.data import vectors as rvectors
from repro.index import graph as rgraph
from repro.index.protocol import replace as rreplace
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.index import graph
from repro_torch.kernels import graph_scan as gs
from repro_torch.testing import assert_topk_close, dot_tol

GATHERED = ("full", "sphering", "gleanvec", "sphering-int8", "gleanvec-int8")
N, D, C, DLOW = 1200, 32, 4, 8
BEAM, HOPS, NQ = 24, 96, 12


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


class _World:
    def __init__(self):
        self.ds = rvectors.make_dataset("graph-gathered", n=N, d=D,
                                        n_queries=48, ood=True, seed=7)
        self.x = jnp.asarray(self.ds.database)
        q = jnp.asarray(self.ds.queries_learn)
        self.models = {"sphering": rlvs.fit(q, self.x, DLOW),
                       "gleanvec": rgv.fit(jax.random.PRNGKey(1), q, self.x,
                                           c=C, d=DLOW)}
        self.g = rgraph.build(self.ds.database, r=12, n_iters=3, seed=0)
        self._scorers = {}

    def model(self, mode):
        if mode == "full":
            return None
        return self.models["sphering" if mode.startswith("sphering")
                           else "gleanvec"]

    def scorer(self, mode):
        if mode not in self._scorers:
            s = rsc.build_scorer(mode, self.x, self.model(mode))
            self._scorers[mode] = (s, convert.scorer(
                type(s).__name__, convert.arrays_of(s), "cpu"))
        return self._scorers[mode]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return _World()


def _tol(qstate, scorer):
    qs, lo = qstate, 0.0
    if isinstance(qstate, tuple):
        qs, lo = qstate.q_scaled, float(qstate.q_lo.abs().max())
    rows = scorer.codes if hasattr(scorer, "codes") else scorer.x_low
    return dot_tol(float(qs.norm(dim=-1).max()),
                   float(rows.to(torch.float32).norm(dim=1).max()),
                   rows.shape[1], lo)


def _best_first(vals, ids):
    sel = graph._best_slots(vals, vals.shape[1])
    return torch.gather(vals, 1, sel), torch.gather(ids, 1, sel)


def _one_launch(qstate, scorer, g, expand):
    """The lowering as ``_beam_qstate`` runs it: (vals, ids, hops (m,))."""
    m = (qstate.q_scaled if isinstance(qstate, tuple) else qstate).shape[0]
    bv, bi = graph._entry_beam(graph._score_ids_of(qstate, scorer), g, m,
                               BEAM)
    return K.scorer_beam_search(scorer, qstate, g.neighbors, bv, bi, HOPS,
                                expand)


def _per_hop(qstate, scorer, g, expand):
    """The per-hop loop over the gathered merge: (vals, ids, hops)."""
    m = (qstate.q_scaled if isinstance(qstate, tuple) else qstate).shape[0]
    vals, ids, hops, _ = graph._beam_loop(
        graph._score_ids_of(qstate, scorer), g, m, BEAM, HOPS, expand)
    return vals, ids, hops


def _check_against_loop(qstate, scorer, g, expand, label):
    got = _one_launch(qstate, scorer, g, expand)
    want = _per_hop(qstate, scorer, g, expand)
    assert int(got[2].max()) == want[2] > 0, label
    assert_topk_close(_best_first(*got[:2]), _best_first(*want[:2]),
                      _tol(qstate, scorer), label)
    return got


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("mode", GATHERED)
def test_one_launch_equals_per_hop_loop(world, mode, expand, monkeypatch):
    _, ps = world.scorer(mode)
    pg = convert.graph_index(world.g, "cpu")
    assert not pg.fused and K.gathered_beam_lowering(ps)
    q = _t(np.concatenate([world.ds.queries_test[:NQ],
                           world.ds.database[:NQ] + 0.01]))
    qstate = ps.prepare_queries(q)
    got = _check_against_loop(qstate, ps, pg, expand, f"{mode}/e{expand}")
    # the queries stop on their own, many hops apart
    assert int(got[2].max()) - int(got[2].min()) >= 2, got[2].tolist()

    # the public path: one traversal, no per-hop loop, the most hops
    calls = []
    plain = gs.graph_beam_search_plain

    def spy(*a, **k):
        calls.append(a[5].shape)
        return plain(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the per-hop loop ran")

    monkeypatch.setattr(gs, "graph_beam_search_plain", spy)
    monkeypatch.setattr(graph, "_beam_loop", refuse)
    before = K.graph_beam_search.launches
    top = graph._beam_qstate(qstate, ps, pg, 10, BEAM, HOPS, expand=expand)
    assert len(calls) == 1 and K.graph_beam_search.launches == before
    assert torch.is_tensor(top[2]) and int(top[2]) == int(got[2].max())
    sel = graph._best_slots(got[0], 10)
    assert torch.equal(top[0], torch.gather(got[0], 1, sel))
    assert torch.equal(top[1], torch.gather(got[1], 1, sel))
    monkeypatch.undo()
    if hasattr(ps, "tags"):     # Figure 7's tag trace keeps the loop
        traced = graph._beam_qstate(qstate, ps, pg, 10, BEAM, HOPS,
                                    expand=expand, trace_tags=ps.tags)
        assert traced[2] == int(top[2]) and traced[3] is not None


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("mode", GATHERED)
def test_one_launch_matches_reference(world, mode, expand):
    rs, ps = world.scorer(mode)
    rg = rreplace(world.g, beam=BEAM, max_hops=HOPS, expand=expand)
    pg = convert.graph_index(rg, "cpu")
    q = world.ds.queries_test[:NQ]
    want = rgraph.beam_search_scorer(jnp.asarray(q), rs, rg, 10, beam=BEAM,
                                     max_hops=HOPS, expand=expand)
    want_hops = rgraph._beam_qstate(rs.prepare_queries(jnp.asarray(q)), rs,
                                    rg, 10, BEAM, HOPS, expand=expand)[2]
    pq = ps.prepare_queries(_t(q))
    got = graph._beam_qstate(pq, ps, pg, 10, BEAM, HOPS, expand=expand)
    assert int(got[2]) == int(want_hops) > 0
    assert_topk_close(got[:2], tuple(np.asarray(w) for w in want),
                      _tol(pq, ps), f"{mode}/e{expand} vs reference")
    top = graph.beam_search_scorer(_t(q), ps, pg, 10, beam=BEAM,
                                   max_hops=HOPS, expand=expand)
    assert all(torch.equal(a, b) for a, b in zip(top, got[:2]))


N0, CAP, INSERTS = 900, 1024, 64


def test_one_launch_after_a_stream_cycle(world):
    """``with_capacity`` + ``insert_ids`` + ``remove_rows``: the edge table
    keeps one row an id over the store's capacity, the lowering's
    ``row_ids`` are the rows with the removed ones at -1, and the one
    launch agrees with the loop and the reference; no removed id comes
    back."""
    mode = "gleanvec-int8"
    x = world.x
    gvm = world.models["gleanvec"]
    rart = rst.build_streaming_artifacts(mode, x[:N0], gvm, capacity=CAP)
    rg = rreplace(rgraph.build(world.ds.database[:N0], r=12, n_iters=3,
                               seed=0), beam=BEAM, max_hops=HOPS, expand=4)
    rg = rgraph.with_capacity(rg, CAP)
    rows = x[N0:N0 + INSERTS]
    rart, new_ids = rst.insert_rows(rart, rows)
    rg = rgraph.insert_ids(rg, rows, np.asarray(new_ids), rart.scorer,
                           rart.x_full)
    entries = set(np.asarray(rg.entries).tolist())
    rm = np.array([i for i in range(3, N0 + INSERTS, 11)
                   if i not in entries], np.int32)
    rart = rst.remove_rows(rart, rm)
    ps = convert.scorer(type(rart.scorer).__name__,
                        convert.arrays_of(rart.scorer), "cpu")
    pg = convert.graph_index(rg, "cpu")
    assert pg.neighbors.shape[0] == ps.n_rows == CAP
    block_tags, row_ids = K._gathered_layout(ps.codes, ps.tags, ps.live)
    assert torch.equal(row_ids, torch.where(
        ps.live, torch.arange(CAP, dtype=torch.int32),
        torch.full((CAP,), -1, dtype=torch.int32)))
    assert bool((row_ids[torch.from_numpy(rm).long()] == -1).all())
    assert torch.equal(block_tags, ps.tags.to(torch.int32))
    # made once a scorer's tensors
    assert K._gathered_layout(ps.codes, ps.tags, ps.live)[1] is row_ids

    q = world.ds.queries_test[:NQ]
    pq = ps.prepare_queries(_t(q))
    _check_against_loop(pq, ps, pg, 4, "streamed")
    got = pg.search(_t(q), ps, 10)
    assert not np.isin(_np(got[1]), rm).any()
    want = rg.search(jnp.asarray(q), rart.scorer, 10)
    assert_topk_close(got, tuple(np.asarray(w) for w in want),
                      _tol(pq, ps), "streamed vs reference")


@pytest.mark.parametrize("mode", ["full", "gleanvec-int8"])
def test_layout_cache_keeps_one_entry_a_store(world, mode):
    """Removes keep a scorer's store tensor and make a new live mask each
    time: the layout is made again for each new mask, the cache holds one
    entry for the store whatever the number of removes, each layout reads
    its own scorer's mask, and the entry goes with the store."""
    _, ps = world.scorer(mode)
    field = "codes" if hasattr(ps, "codes") else "x_low"
    ps = ps._replace(**{field: getattr(ps, field).clone()})  # this test's
    rows = getattr(ps, field)
    pg = convert.graph_index(world.g, "cpu")
    before = len(K._GATHERED_LAYOUTS)
    q = world.ds.queries_test[:2]
    for cycle in range(6):
        ps = ps.remove_rows(torch.arange(cycle, N, 97))
        pq = ps.prepare_queries(_t(q))
        got = _one_launch(pq, ps, pg, 1)
        _, row_ids = K._gathered_layout(rows, getattr(ps, "tags", None),
                                        ps.live)
        assert torch.equal(row_ids >= 0, ps.live), cycle
        assert K._gathered_layout(rows, getattr(ps, "tags", None),
                                  ps.live)[1] is row_ids
        assert len(K._GATHERED_LAYOUTS) == before + 1, cycle
    key = id(rows)
    del ps, pq, got, row_ids, rows
    assert key not in K._GATHERED_LAYOUTS
