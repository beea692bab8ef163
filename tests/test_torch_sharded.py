"""The port's sharded placement against the JAX reference.

The reference fits once, builds its mesh-free ``ShardedIndex`` stacks, and
``repro_torch.convert`` carries the stacked scorers and indexes across, so
both packages search the same shards. Checks:

* ``stack_shards`` leaves equal the reference's bit for bit, padding
  included (ragged sorted layouts, posting lists, entry points);
* ``search_local`` for flat (sphering, gleanvec, gleanvec-int8-sorted),
  the k-means IVF, the aligned IVF (both sorted modes, reduced probe) and
  the fused graph against the reference's;
* port-internal: the sharded flat placement equals the unsharded flat
  scan; a globally built scorer in row shards (``shard_rows``, the
  scorer-level ``globalize_ids``) equals it for all six scorer classes;
* the sharded IVF builds' lists equal the reference's;
* the host tier (``build_sharded_artifacts(spill_host=True)``) serves the
  device tier's ids; ``refreshed`` reaches every shard and keeps every
  shape, and the engine swaps it in;
* ``restore_distributed`` of a reference checkpoint; the ``ValueError`` s;
  ``--shards`` through the CLI;
* four gloo processes: ``ShardedIndex(group=...)`` and
  ``make_sharded_search_scorer`` give the single-device results.

JAX is imported inside the CPU tests only, so ``-m cuda`` runs this file
on a machine without it. Tolerance: fp32 products summed in another order
(``testing.dot_tol``); ids may differ only at near-ties of the k-th value.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert, tree
from repro_torch.core import metrics
from repro_torch.core import scorer as sc
from repro_torch.core import search as msearch
from repro_torch.core import rerank_tier
from repro_torch.index import distributed, ivf
from repro_torch.index.distributed import ShardedIndex, stack_shards
from repro_torch.index.protocol import FlatIndex
from repro_torch.serve.engine import ServingEngine
from repro_torch.testing import (assert_topk_close, dot_tol, merged_shards,
                                 row_shards_merged)

N, D, DR, C, S, BLOCK, NQ, K, KAPPA = 2048, 32, 8, 4, 4, 64, 16, 10, 20
SORTED = ("gleanvec-sorted", "gleanvec-int8-sorted")
GRAPH_KW = {"r": 12, "n_iters": 3, "seed": 0}
ROOT = Path(__file__).resolve().parents[1]


class _World:
    """The reference's data, fits and sharded builds."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from repro.core import gleanvec as rgv
        from repro.core import leanvec_sphering as rlvs
        from repro.data import vectors as rvectors
        self.ds = rvectors.make_dataset("sharded", n=N, d=D, n_queries=64,
                                        ood=True, seed=3)
        self.x = jnp.asarray(self.ds.database)
        q = jnp.asarray(self.ds.queries_learn)
        self.models = {"sphering": rlvs.fit(q, self.x, DR),
                       "gleanvec": rgv.fit(jax.random.PRNGKey(0), q, self.x,
                                           c=C, d=DR, kmeans_iters=6)}
        self.queries = self.ds.queries_test[:NQ]
        self._built = {}

    def model(self, mode):
        return self.models["sphering" if mode.startswith("sphering")
                           else "gleanvec"]

    def port_model(self, mode):
        build = convert.sphering_model if mode.startswith("sphering") \
            else convert.gleanvec_model
        return build(convert.arrays_of(self.model(mode)), "cpu")

    def build(self, kind, mode, **kw):
        """The reference's (ShardedIndex, stacked scorer), cached."""
        import jax
        from repro.index import distributed as rdist
        key = (kind, mode, tuple(sorted(kw.items())))
        if key not in self._built:
            extra = {"graph_kwargs": GRAPH_KW} if kind == "graph" else {}
            self._built[key] = rdist.build_sharded_index(
                kind, mode, self.x, self.model(mode), n_shards=S,
                key=jax.random.PRNGKey(1), sort_block=BLOCK, n_lists=C,
                **extra, **kw)
        return self._built[key]

    def shards(self, kind, mode, aligned=False, reduced_probe=False,
               fused_graph=False):
        """The reference's per-shard (scorers, sub-indexes), unstacked, as
        its ``build_sharded_index`` makes them."""
        import jax
        import numpy as onp
        from repro.core import scorer as rsc
        from repro.index import graph as rgraph
        from repro.index import ivf as rivf
        model, per = self.model(mode), N // S
        rows = [self.x[s * per:(s + 1) * per] for s in range(S)]
        scorers = [rsc.build_scorer(mode, r, model, block=BLOCK)
                   for r in rows]
        if kind == "flat":
            return scorers, [None] * S
        if kind == "ivf":
            subs = (rivf.build_aligned_sharded(model, self.x, S) if aligned
                    else rivf.build_sharded(jax.random.PRNGKey(1), self.x, C,
                                            S))
            if reduced_probe:
                subs = [rivf.with_reduced_centers(ix, sr, model)
                        for ix, sr in zip(subs, scorers)]
            return scorers, subs
        subs = [rgraph.build(onp.asarray(r), **GRAPH_KW) for r in rows]
        if fused_graph:
            subs = [rgraph.with_fused_scan(ix, sr)
                    for ix, sr in zip(subs, scorers)]
        return scorers, subs


@pytest.fixture(scope="module")
def world():
    return _World()


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_scorer(s):
    return convert.scorer(type(s).__name__, convert.arrays_of(s), "cpu")


def _port_sub_index(kind, sub):
    if kind == "ivf":
        return convert.ivf_index(sub, "cpu")
    if kind == "graph":
        return convert.graph_index(sub, "cpu")
    return FlatIndex()


def _port_sharded(kind, ref):
    """The reference's sharded index and stacked scorer, carried across."""
    rsh, rst = ref
    return (ShardedIndex(sub_index=_port_sub_index(kind, rsh.sub_index),
                         row_starts=_t(rsh.row_starts).to(torch.int32)),
            _port_scorer(rst))


def _norm(t):
    t = t.to(torch.float32)
    return float(torch.linalg.norm(t.reshape(-1, t.shape[-1]), dim=1).max())


def _tol(stacked, queries):
    """``dot_tol`` of the worst shard's prepared queries and rows."""
    tol = 0.0
    for s in range(stacked[0].shape[0]):
        scorer = distributed._take_shard(stacked, s)
        qs, lo = scorer.prepare_queries(queries), 0.0
        if isinstance(qs, tuple):
            qs, lo = qs.q_scaled, float(qs.q_lo.abs().max())
        rows = scorer.x_low if hasattr(scorer, "x_low") else scorer.codes
        tol = max(tol, dot_tol(_norm(qs), _norm(rows), rows.shape[1], lo))
    return tol


def _equal_trees(got, want):
    g_paths, g, g_def = tree.flatten_with_paths(got)
    _, w, w_def = tree.flatten_with_paths(want)
    assert g_def == w_def
    for p, a, b in zip(g_paths, g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), p


# ---------------------------------------------------------------------------
# stack_shards against the reference.
# ---------------------------------------------------------------------------


STACKS = [("flat", "gleanvec-int8-sorted", {}),
          ("ivf", "gleanvec-sorted", {"aligned": True,
                                      "reduced_probe": True}),
          ("ivf", "gleanvec-int8", {"reduced_probe": True}),
          ("graph", "gleanvec-int8-sorted", {"fused_graph": True})]


@pytest.mark.parametrize("kind,mode,kw", STACKS,
                         ids=[f"{k}-{m}" for k, m, _ in STACKS])
def test_stack_shards_matches_reference(world, kind, mode, kw):
    """Each shard's scorer and sub-index carried across alone, stacked by
    the port: every leaf equals the reference's stack bit for bit, its
    -1 / 0 padding included."""
    from repro.index import distributed as rdist
    r_scorers, r_subs = world.shards(kind, mode, **kw)
    shards_s = [_port_scorer(r) for r in r_scorers]
    shards_i = [_port_sub_index(kind, r) for r in r_subs]
    got_s, got_i = stack_shards(shards_s), stack_shards(shards_i)
    _equal_trees(got_s, _port_scorer(rdist.stack_shards(r_scorers)))
    if kind != "flat":
        _equal_trees(got_i, _port_sub_index(kind,
                                            rdist.stack_shards(r_subs)))
    # per-shard sorted layouts are ragged: some shard's leaf was padded
    padded = any(tuple(a.shape) != tuple(b.shape[1:])
                 for part, stacked in ((shards_s, got_s), (shards_i, got_i))
                 for sh in part
                 for a, b in zip(tree.leaves(sh), tree.leaves(stacked)))
    if mode.endswith("sorted"):
        assert padded, "no leaf needed padding: the check is vacuous"


def test_stack_shards_pad_values():
    """The padding rule: signed integers -1, unsigned, float and bool 0."""
    a = sc.SortedGleanVecQuantizedScorer(
        codes=torch.full((2, 3), 7, dtype=torch.uint8),
        block_tags=torch.tensor([1], dtype=torch.int32),
        perm=torch.tensor([4, 5], dtype=torch.int32),
        inv_perm=torch.tensor([0, 1], dtype=torch.int32),
        lo=torch.ones(2, 3), delta=torch.ones(2, 3), a=torch.ones(2, 3, 4))
    b = a._replace(codes=torch.full((4, 3), 9, dtype=torch.uint8),
                   block_tags=torch.tensor([0, 1], dtype=torch.int32),
                   perm=torch.tensor([0, 1, 2, 3], dtype=torch.int32))
    st = stack_shards([a, b])
    assert st.codes.shape == (2, 4, 3) and int(st.codes[0, 3, 0]) == 0
    assert st.block_tags.tolist() == [[1, -1], [0, 1]]
    assert st.perm[0].tolist() == [4, 5, -1, -1]
    live = stack_shards([torch.ones(2, dtype=torch.bool),
                         torch.ones(3, dtype=torch.bool)])
    assert live.tolist() == [[True, True, False], [True, True, True]]
    one = distributed._take_shard(st, 0)
    assert one.layout_block == 2          # (ns, blocks) padded alike
    assert one.codes.is_contiguous() and one.codes.data_ptr() == \
        st.codes.data_ptr()


# ---------------------------------------------------------------------------
# search_local against the reference.
# ---------------------------------------------------------------------------


SEARCHES = [("flat", "sphering", {}), ("flat", "gleanvec", {}),
            ("flat", "gleanvec-int8-sorted", {}),
            ("ivf", "gleanvec-int8", {"nprobe": 2}),
            ("ivf", "gleanvec-sorted", {"aligned": True,
                                        "reduced_probe": True, "nprobe": 2}),
            ("ivf", "gleanvec-int8-sorted", {"aligned": True,
                                             "reduced_probe": True,
                                             "nprobe": 2}),
            ("graph", "gleanvec-int8-sorted",
             {"fused_graph": True, "beam": 32, "max_hops": 48,
              "expand": 2})]


@pytest.mark.parametrize("kind,mode,kw", SEARCHES,
                         ids=[f"{k}-{m}{'-aligned' if 'aligned' in kw else ''}"
                              for k, m, kw in SEARCHES])
def test_search_local_matches_reference(world, kind, mode, kw):
    """The same stacks searched by both packages: the merged kappa
    candidates agree within ``dot_tol``, ids up to near-ties."""
    import jax.numpy as jnp
    ref = world.build(kind, mode, **kw)
    want = ref[0].search_local(jnp.asarray(world.queries), ref[1], KAPPA)
    sh, st = _port_sharded(kind, ref)
    q = _t(world.queries)
    got = sh.search_local(q, st, KAPPA)
    assert_topk_close(got, want, _tol(st, q), f"{kind}/{mode}")
    # the protocol path (the serving one) is search_local without a group
    torch.testing.assert_close(sh.search(q, st, KAPPA)[1], got[1])


def test_sharded_ivf_builds_match_reference(world):
    """One coarse quantizer, per-shard LOCAL posting lists, a common
    max_len: the port's builds give the reference's lists (the k-means
    centers carried across as the start, no iteration)."""
    rsh, _ = world.build("ivf", "gleanvec-int8")
    x = _t(world.ds.database)
    got = ivf.build_sharded(x, C, S, n_iters=0,
                            init_centers=_t(rsh.sub_index.centers[0]),
                            device="cpu")
    want = np.asarray(rsh.sub_index.lists)
    assert np.array_equal(torch.stack([g.lists for g in got]).numpy(), want)
    rsh, _ = world.build("ivf", "gleanvec-sorted", aligned=True,
                         reduced_probe=True)
    got = ivf.build_aligned_sharded(world.port_model("gleanvec"), x, S,
                                    device="cpu")
    assert all(g.aligned_layout for g in got)
    assert np.array_equal(torch.stack([g.lists for g in got]).numpy(),
                          np.asarray(rsh.sub_index.lists))


# ---------------------------------------------------------------------------
# Port-internal equalities.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sphering", "gleanvec", "gleanvec-sorted"])
def test_sharded_flat_equals_unsharded(world, mode):
    """A row's encoding does not depend on its shard in these modes, so
    the union of the shards' top-kappa holds the global top-kappa: the
    port's own sharded build equals the single-device flat scan."""
    x, q = _t(world.ds.database), _t(world.queries)
    model = world.port_model(mode)
    sh, st = distributed.build_sharded_index("flat", mode, x, model,
                                             n_shards=S, sort_block=BLOCK,
                                             device="cpu")
    single = sc.build_scorer(mode, x, model, block=BLOCK, device="cpu")
    want = FlatIndex().search(q, single, KAPPA)
    assert_topk_close(sh.search(q, st, KAPPA), want, _tol(st, q), mode)


@pytest.mark.parametrize("mode", ["sphering-int8", "gleanvec-int8",
                                  "gleanvec-int8-sorted"])
def test_sharded_int8_flat_equals_its_folded_scan(world, mode):
    """Each shard fits its own int8 scales, so a scan of one globally
    fitted scorer is not the reference here: ``testing.sharded_as_one``
    folds the shards into one scorer that scores every row as its shard
    does, and its single-device scan (the gathered kernel's plain version)
    equals the sharded merge."""
    from repro_torch.testing import sharded_as_one
    x, q = _t(world.ds.database), _t(world.queries)
    sh, st = distributed.build_sharded_index("flat", mode, x,
                                             world.port_model(mode),
                                             n_shards=S, sort_block=BLOCK,
                                             device="cpu")
    one = sharded_as_one(st)
    assert one.n_rows == N and one.lo.shape[0] == S * (
        1 if mode.startswith("sphering") else C)
    assert_topk_close(sh.search(q, st, KAPPA),
                      FlatIndex().search(q, one, KAPPA),
                      max(_tol(st, q), _tol_one(one, q)), mode)


def _balanced_scorers():
    """The reference test's six layouts over 4 balanced tags: 8 single-tag
    blocks of 256, so 4 row shards never split a block."""
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import quantization as quant
    rng = np.random.default_rng(0)
    n, d, dim, c = 2048, 16, 32, 4
    x_low = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    tags = torch.as_tensor(np.repeat(np.arange(c), n // c)[
        rng.permutation(n)], dtype=torch.int32)
    a = torch.as_tensor(rng.standard_normal((c, d, dim)), dtype=torch.float32)
    a_lin = a[0]
    sq = quant.quantize_per_cluster(x_low, tags, c)
    sq_lin = quant.quantize(x_low)
    xs, btags, perm = gv.sort_by_tag(tags, x_low, block=256)
    cs, _, _ = gv.sort_by_tag(tags, sq.codes, block=256)
    inv = gv.inverse_permutation(perm, n)
    q = torch.as_tensor(rng.standard_normal((8, dim)), dtype=torch.float32)
    return q, [
        sc.LinearScorer(x_low=x_low, a=a_lin),
        sc.QuantizedScorer(codes=sq_lin.codes, lo=sq_lin.lo,
                           delta=sq_lin.delta, a=a_lin),
        sc.GleanVecScorer(x_low=x_low, tags=tags, a=a),
        sc.GleanVecQuantizedScorer(codes=sq.codes, tags=tags, lo=sq.lo,
                                   delta=sq.delta, a=a),
        sc.SortedGleanVecScorer(x_low=xs, block_tags=btags, perm=perm,
                                inv_perm=inv, a=a),
        sc.SortedGleanVecQuantizedScorer(codes=cs, block_tags=btags,
                                         perm=perm, inv_perm=inv, lo=sq.lo,
                                         delta=sq.delta, a=a)]


def test_row_sharded_scorers_equal_single_device():
    """The shard contract of placement 1 on one device: each of the six
    scorer classes, built once and cut into 4 row shards (views; the sorted
    ones keep their global ``perm``), each shard scanned alone and its ids
    lifted by ``globalize_ids``, merges to the single-device scan's top-k
    exactly."""
    q, scorers = _balanced_scorers()
    for s in scorers:
        want = FlatIndex().search(q, s, 5)
        got = row_shards_merged(q, s, 4, 5)
        name = type(s).__name__
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4,
                                   msg=name)
        assert torch.equal(got[1], want[1]), name
        part = s.shard_rows(1, 4)
        assert type(part) is type(s) and part.n_rows == s.n_rows // 4
        leaf = part.x_low if hasattr(part, "x_low") else part.codes
        full = s.x_low if hasattr(s, "x_low") else s.codes
        assert leaf.data_ptr() == full[s.n_rows // 4].data_ptr(), name
    ids = torch.tensor([[0, 3, -1]], dtype=torch.int32)
    assert scorers[0].shard_rows(2, 4).globalize_ids(ids, 2).tolist() == \
        [[1024, 1027, -1]]
    assert torch.equal(scorers[4].globalize_ids(ids, 2), ids)
    with pytest.raises(ValueError, match="whole blocks"):
        scorers[5].shard_rows(0, 3)


@pytest.mark.parametrize("mode", SORTED)
def test_aligned_ivf_equals_per_shard_builds(world, mode):
    """The sharded aligned IVF (reduced probe) equals its shards built on
    their own -- ``build_aligned`` + ``with_reduced_centers`` over each
    shard's rows with that shard's scorer (its own int8 scales), searched
    alone, lifted by the row start and merged by hand."""
    x = _t(world.ds.database)
    model = world.port_model("gleanvec")
    q = _t(world.queries)
    sh, st = distributed.build_sharded_index(
        "ivf", mode, x, model, n_shards=S, sort_block=BLOCK, aligned=True,
        reduced_probe=True, nprobe=2, device="cpu")
    got = sh.search(q, st, KAPPA)
    per, parts = N // S, []
    for s in range(S):
        rows = x[s * per:(s + 1) * per]
        one = sc.build_scorer(mode, rows, model, block=BLOCK, device="cpu")
        idx = ivf.with_reduced_centers(
            ivf.build_aligned(model, rows, nprobe=2, device="cpu"), one,
            model)
        vals, ids = idx.search(q, one, KAPPA)
        parts.append((vals, idx.globalize_ids(one, ids, s * per)))
    assert_topk_close(got, merged_shards(parts, KAPPA), _tol(st, q),
                      f"aligned ivf {mode} vs per-shard builds")


# ---------------------------------------------------------------------------
# Serving: the host tier, refreshed, the engine's swap.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_sharded_spill_matches_device_tier(world, kind):
    """``build_sharded_artifacts(spill_host=True)``: the candidates' global
    ids route through per-shard host buffers, and the pipelined submit
    returns the device tier's ids."""
    x = _t(world.ds.database)
    model = world.port_model("gleanvec")
    kw = dict(n_shards=S, n_lists=C, nprobe=2, device="cpu",
              generator=torch.Generator().manual_seed(1))
    out = {}
    for spill in (False, True):
        kw["generator"] = torch.Generator().manual_seed(1)
        sh, art = distributed.build_sharded_artifacts(
            kind, "gleanvec", x, model, spill_host=spill, **kw)
        eng = ServingEngine(msearch.make_state(art, index=sh), k=K,
                            kappa=KAPPA, batch_size=16, dim=D)
        out[spill] = eng.submit(world.ds.queries_test)
        if spill:
            store = msearch.host_tier(art)
            assert isinstance(store, rerank_tier.ShardedHostStore)
            assert store.n_shards == S and store.shape == (N, D)
            assert eng.stats.host_bytes_ratio == 1.0
    np.testing.assert_array_equal(out[True], out[False])
    assert metrics.recall_at_k(out[True], world.ds.gt[:, :K]) > 0.8


def test_refreshed_reaches_every_shard_and_swaps(world):
    """``refreshed`` re-derives each shard's ``nbr_rows`` from THAT shard's
    scorer (a zeroed table comes back whole), keeps the structure and
    every leaf's shape, and the engine swaps it in with the ids
    unchanged."""
    x = _t(world.ds.database)
    model = world.port_model("gleanvec")
    sh, art = distributed.build_sharded_artifacts(
        "graph", "gleanvec-sorted", x, model, n_shards=S, sort_block=BLOCK,
        beam=32, max_hops=48, fused_graph=True, graph_kwargs=GRAPH_KW,
        device="cpu")
    good = sh.sub_index.nbr_rows
    broken = dataclasses.replace(sh, sub_index=dataclasses.replace(
        sh.sub_index, nbr_rows=torch.zeros_like(good)))
    fixed = broken.refreshed(art.scorer, model)
    assert torch.equal(fixed.sub_index.nbr_rows, good)
    assert tree.structure(fixed) == tree.structure(sh)
    for a, b in zip(tree.leaves(fixed), tree.leaves(sh)):
        assert a.shape == b.shape and a.dtype == b.dtype
    eng = ServingEngine(msearch.make_state(art, index=sh), k=K, kappa=KAPPA,
                        batch_size=16, dim=D)
    before = eng.submit(world.queries)
    eng.swap(eng.state._replace(index=sh.refreshed(art.scorer, model)))
    np.testing.assert_array_equal(eng.submit(world.queries), before)
    with pytest.raises(ValueError, match="structure"):
        eng.swap(eng.state._replace(index=FlatIndex()))


def test_build_sharded_index_value_errors(world):
    x = _t(world.ds.database)
    model = world.port_model("gleanvec")
    with pytest.raises(ValueError, match="sorted"):
        distributed.build_sharded_index("ivf", "gleanvec", x, model,
                                        n_shards=2, aligned=True,
                                        device="cpu")
    with pytest.raises(ValueError, match="sorted"):
        distributed.build_sharded_index("graph", "gleanvec", x, model,
                                        n_shards=2, fused_graph=True,
                                        device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        distributed.build_sharded_index("flat", "gleanvec", x[:2047], model,
                                        n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        distributed.build_sharded_index("flat", "gleanvec", x, model,
                                        device="cpu")
    with pytest.raises(ValueError, match="unknown index kind"):
        distributed.build_sharded_index("lsh", "gleanvec", x, model,
                                        n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        ivf.build_aligned_sharded(model, x[:2047], 2, device="cpu")


# ---------------------------------------------------------------------------
# Checkpoints and the CLI.
# ---------------------------------------------------------------------------


def test_restore_distributed_of_reference_checkpoint(tmp_path):
    """A checkpoint the reference wrote restores in the port onto another
    placement: whole on a device, or one rank's row slice."""
    import jax.numpy as jnp
    from repro.train import checkpoint as rckpt
    from repro_torch.train import checkpoint
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    ids = np.arange(8, dtype=np.int32)
    rckpt.save(str(tmp_path), 1, {"x": jnp.asarray(x), "ids": ids})
    target = {"x": torch.zeros(8, 16), "ids": torch.zeros(8,
                                                          dtype=torch.int32)}
    got, step, _ = checkpoint.restore_distributed(str(tmp_path), target,
                                                  "cpu")
    assert step == 1 and isinstance(got["x"], torch.Tensor)
    np.testing.assert_array_equal(got["x"].numpy(), x)
    place = {"x": checkpoint.RowShard("cpu", rank=1, n_shards=2),
             "ids": torch.device("cpu")}
    got, _, _ = checkpoint.restore_distributed(str(tmp_path), target, place)
    np.testing.assert_array_equal(got["x"].numpy(), x[4:])
    assert got["ids"].dtype == torch.int32 and got["ids"].tolist() == \
        list(range(8))
    with pytest.raises(ValueError, match="structure"):
        checkpoint.restore_distributed(str(tmp_path), target, {"x": "cpu"})


SMALL = ["--n", "2000", "--dim", "32", "--d", "8", "--clusters", "4",
         "--batch", "64", "--kappa", "40", "--device", "cpu"]
CLI_CASES = [(["--mode", "gleanvec"], 0.85),
             (["--mode", "gleanvec-int8-sorted", "--index", "ivf",
               "--aligned", "--reduced-probe", "--nprobe", "3"], 0.8),
             (["--mode", "gleanvec-int8-sorted", "--index", "graph",
               "--fused-graph", "--beam", "32", "--expand", "4"], 0.7)]


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
@pytest.mark.parametrize("flags,floor", CLI_CASES,
                         ids=["flat", "ivf-aligned", "graph-fused"])
def test_cli_shards(flags, floor, host, capsys):
    """``--shards 2`` on the CPU: the placement line and recall@10 above
    the reference's own sharded floors (flat 0.85, IVF 0.8, graph 0.7)."""
    from repro_torch.launch import serve
    serve.main(flags + ["--shards", "2"] + SMALL
               + (["--host-rerank"] if host else []))
    out = capsys.readouterr().out
    assert "placement=shards=2" in out, out
    assert float(out.split("recall@10=")[1].split()[0]) >= floor, out
    if host:
        assert "host_bytes_ratio=1.00" in out, out


def test_cli_shards_refusals():
    from repro_torch.launch import serve
    for extra in (["--stream"], ["--frontend"]):
        with pytest.raises(SystemExit, match="single-device index"):
            serve.main(["--mode", "gleanvec-int8", "--shards", "2"] + extra
                       + SMALL)
    with pytest.raises(SystemExit, match="sorted"):
        serve.main(["--mode", "gleanvec", "--index", "ivf", "--aligned",
                    "--shards", "2"] + SMALL)


# ---------------------------------------------------------------------------
# Four gloo processes.
# ---------------------------------------------------------------------------


GLOO_SCRIPT = textwrap.dedent("""
    import datetime, os, sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        from repro_torch.index import distributed
        from repro_torch.index.protocol import FlatIndex
        from repro_torch.serve.lifecycle import template_model
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.standard_normal((1024, 32)),
                            dtype=torch.float32)
        q = torch.as_tensor(rng.standard_normal((8, 32)), dtype=torch.float32)
        model = template_model("gleanvec", 32, 8, clusters=4, device="cpu")
        cases = [("flat", m, {{}}) for m in
                 ("gleanvec", "gleanvec-int8", "gleanvec-sorted",
                  "gleanvec-int8-sorted")]
        cases += [("ivf", "gleanvec-int8-sorted",
                   {{"aligned": True, "reduced_probe": True, "nprobe": 2}}),
                  ("graph", "gleanvec-sorted",
                   {{"fused_graph": True, "beam": 32, "max_hops": 32,
                     "graph_kwargs": {{"r": 8, "n_iters": 2, "seed": 0}}}})]
        for kind, mode, kw in cases:
            sh, st = distributed.build_sharded_index(
                kind, mode, x, model, group=dist.group.WORLD, sort_block=32,
                device="cpu", **kw)
            assert st[0].shape[0] == 1 and sh.n_shards == world
            got = sh.search(q, st, 10)
            one, ost = distributed.build_sharded_index(
                kind, mode, x, model, n_shards=world, sort_block=32,
                device="cpu", **kw)
            want = one.search_local(q, ost, 10)
            assert torch.equal(got[1], want[1]), (kind, mode)
            assert torch.allclose(got[0], want[0]), (kind, mode)
        # placement 1: the four GleanVec scorers built once over 4
        # balanced tags (16 single-tag blocks of 64), row-sharded
        from repro_torch.core import scorer as sc
        from repro_torch.core import gleanvec as gv
        from repro_torch.core import quantization as quant
        tags = torch.as_tensor(np.repeat(np.arange(4), 256)[
            rng.permutation(1024)], dtype=torch.int32)
        x_low = torch.as_tensor(rng.standard_normal((1024, 8)),
                                dtype=torch.float32)
        a = model.a
        sq = quant.quantize_per_cluster(x_low, tags, 4)
        xs, btags, perm = gv.sort_by_tag(tags, x_low, block=64)
        cs, _, _ = gv.sort_by_tag(tags, sq.codes, block=64)
        inv = gv.inverse_permutation(perm, 1024)
        for full in (
                sc.GleanVecScorer(x_low=x_low, tags=tags, a=a),
                sc.GleanVecQuantizedScorer(codes=sq.codes, tags=tags,
                                           lo=sq.lo, delta=sq.delta, a=a),
                sc.SortedGleanVecScorer(x_low=xs, block_tags=btags,
                                        perm=perm, inv_perm=inv, a=a),
                sc.SortedGleanVecQuantizedScorer(
                    codes=cs, block_tags=btags, perm=perm, inv_perm=inv,
                    lo=sq.lo, delta=sq.delta, a=a)):
            name = type(full).__name__
            fn = distributed.make_sharded_search_scorer(
                dist.group.WORLD, 10, full, kappa=10)
            got = fn(q, full.shard_rows(rank, world))
            want = FlatIndex().search(q, full, 10)
            assert torch.equal(got[1], want[1]), name
            assert torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-5), name
        # the linear entry point: this rank's rows of exact inner products
        rows = x[rank * 256:(rank + 1) * 256]
        got = distributed.sharded_search(q, rows, dist.group.WORLD, 10)
        want = torch.topk(q @ x.T, 10)
        assert torch.equal(got[1], want.indices.to(got[1].dtype))
        assert torch.allclose(got[0], want.values, rtol=1e-5, atol=1e-5)
        dist.barrier()
        if rank == 0:
            print("GLOO_SHARDED_OK", flush=True)
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(run, args=(4, port), nprocs=4)
""")


def test_gloo_four_processes_match_single_device(tmp_path):
    """``ShardedIndex(group=...)`` (flat in the four GleanVec modes, the
    aligned IVF, the fused graph), ``make_sharded_search_scorer`` over
    the four GleanVec scorers and ``sharded_search`` over exact inner
    products, each rank on its own slice, merged by one all-gather a
    field: the single-device results on every rank."""
    script = tmp_path / "gloo_sharded.py"
    script.write_text(GLOO_SCRIPT.format(src=str(ROOT / "src")))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0 and "GLOO_SHARDED_OK" in out.stdout, \
        f"stdout:\\n{out.stdout}\\nstderr:\\n{out.stderr[-4000:]}"


# ---------------------------------------------------------------------------
# The card (chip_smoke.py's phase 3g at a small size).
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_world(dev):
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import leanvec_sphering as lvs
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(40_000, 64, device=dev, generator=g)
    q = torch.randn(300, 64, device=dev, generator=g)
    return x, q, {"gleanvec": gv.fit(q, x, c=6, d=16, kmeans_iters=4,
                                     generator=g, device=dev),
                  "sphering": lvs.fit(q, x, 16, device=dev)}


def _launches():
    from repro_torch import kernels as K
    return {f.__name__: f.launches for f in (
        K.ip_topk, K.gleanvec_sq_topk, K.ivf_scan_topk,
        K.graph_beam_search, K.graph_scan_beam_step)}


def _delta(before):
    return {k: v - before[k] for k, v in _launches().items() if v > before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sphering-int8", "gleanvec-sorted",
                                  "gleanvec-int8-sorted"])
def test_cuda_sharded_flat_one_scan_a_shard(cuda, mode):
    """The per-shard build launches the mode's kernel once a shard and
    merges to the exact candidates: the single-device scan's in the f32
    sorted mode (a row's encoding does not depend on its shard), the
    folded scan's (``testing.sharded_as_one``) in the int8 modes, whose
    shards fit their own scales. A linear int8 scorer built once and cut
    into 4 row shards merges to the single-device scan."""
    from repro_torch.testing import sharded_as_one
    x, q, models = _card_world(cuda)
    model = models["sphering" if mode.startswith("sphering") else
                   "gleanvec"]
    kernel = "ip_topk" if mode.startswith("sphering") else "gleanvec_sq_topk"
    sh, st = distributed.build_sharded_index("flat", mode, x, model,
                                             n_shards=4, sort_block=256,
                                             device=cuda)
    before = _launches()
    got = sh.search(q, st, 100)
    assert _delta(before) == {kernel: 4}
    if mode == "gleanvec-sorted":
        single = sc.build_scorer(mode, x, model, block=256, device=cuda)
        want, tol = FlatIndex().search(q, single, 100), _tol(st, q)
    else:
        one = sharded_as_one(st)
        want = FlatIndex().search(q, one, 100)
        tol = max(_tol(st, q), _tol_one(one, q))
    assert_topk_close(got, want, tol, f"{mode} per shard")
    if mode == "sphering-int8":
        single = sc.build_scorer(mode, x, model, device=cuda)
        before = _launches()
        got = row_shards_merged(q, single, 4, 100)
        assert _delta(before) == {kernel: 4}
        assert_topk_close(got, FlatIndex().search(q, single, 100),
                          _tol_one(single, q), f"{mode} row shards")


def _tol_one(scorer, q):
    return _tol(stack_shards([scorer]), q)


@pytest.mark.cuda
def test_cuda_sharded_aligned_ivf_equals_single_device(cuda):
    """One quantizer serves every shard: the aligned IVF over 4 per-shard
    sorted f32 layouts returns the single-device aligned IVF's candidates,
    with one ``ivf_scan_topk`` launch a shard."""
    x, q, models = _card_world(cuda)
    model = models["gleanvec"]
    single = sc.build_scorer("gleanvec-sorted", x, model, block=256,
                             device=cuda)
    idx = ivf.with_reduced_centers(ivf.build_aligned(model, x, nprobe=3,
                                                     device=cuda),
                                   single, model)
    want = idx.search(q, single, 100)
    sh, st = distributed.build_sharded_index(
        "ivf", "gleanvec-sorted", x, model, n_shards=4, sort_block=256,
        aligned=True, reduced_probe=True, nprobe=3, device=cuda)
    before = _launches()
    got = sh.search(q, st, 100)
    assert _delta(before) == {"ivf_scan_topk": 4}
    assert_topk_close(got, want, _tol(st, q), "aligned ivf")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SORTED)
def test_cuda_sharded_aligned_ivf_equals_per_shard_builds(cuda, mode):
    """Each shard of the sharded aligned IVF against a build of its own:
    ``build_aligned`` + ``with_reduced_centers`` over the shard's rows with
    the shard's scorer (its own int8 scales in the int8 mode), searched
    alone, lifted by its row start and merged by hand. This holds the
    stacking, the per-shard reduced probe, the lift and the merge where the
    int8 shards' scales leave no single-device scan to compare with."""
    x, q, models = _card_world(cuda)
    model = models["gleanvec"]
    sh, st = distributed.build_sharded_index(
        "ivf", mode, x, model, n_shards=4, sort_block=256, aligned=True,
        reduced_probe=True, nprobe=3, device=cuda)
    before = _launches()
    got = sh.search(q, st, 100)
    assert _delta(before) == {"ivf_scan_topk": 4}
    per, parts = x.shape[0] // 4, []
    for s in range(4):
        rows = x[s * per:(s + 1) * per]
        one = sc.build_scorer(mode, rows, model, block=256, device=cuda)
        idx = ivf.with_reduced_centers(
            ivf.build_aligned(model, rows, nprobe=3, device=cuda), one, model)
        vals, ids = idx.search(q, one, 100)
        parts.append((vals, idx.globalize_ids(one, ids, s * per)))
    assert_topk_close(got, merged_shards(parts, 100), _tol(st, q),
                      f"aligned ivf {mode} vs per-shard builds")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SORTED)
def test_cuda_sharded_fused_graph_no_sync(cuda, mode):
    """Four fused per-shard graphs: one ``graph_beam_search`` launch a
    shard, no host sync inside ``candidates``, and the candidates of the
    gathered traversal over the same per-shard graphs (padding rows of the
    stacked layouts are never reached)."""
    x, q, models = _card_world(cuda)
    kw = dict(n_shards=4, sort_block=256, beam=64, max_hops=200, expand=4,
              graph_kwargs={"r": 12, "n_iters": 2, "method": "device"},
              device=cuda)
    sh, st = distributed.build_sharded_index("graph", mode, x,
                                             models["gleanvec"],
                                             fused_graph=True, **kw)
    gathered = dataclasses.replace(sh, sub_index=dataclasses.replace(
        sh.sub_index, fused=False, nbr_rows=None))
    want = gathered.search(q, st, 64)
    qs = sh.prepare_queries(st, q)
    before = _launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sh.candidates(qs, st, 64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _delta(before) == {"graph_beam_search": 4}
    assert_topk_close(got, want, _tol(st, q), f"{mode} fused vs gathered")
