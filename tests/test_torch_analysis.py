"""The port's contract audit (``repro_torch.analysis``): every rule passes
on the real subject and FAILS on a seeded violation -- a dense toy must
fail ``NoDenseScoreMatrix``, a copying swap ``SwapWithoutCopy``, a leaky
store ``LeaflessAuxHostTier``, seeded source trees their lint -- as
``tests/test_analysis.py`` holds the reference's rules. A rule that cannot
fail enforces nothing.

On the CPU (the port's plain paths): the trace rules on toy steps and on
hand-made ``StepTrace`` records for the card-only readings (syncs, peak
memory, device kernels); the protocol rules on one module-scoped
``ProtocolContext``; the source rules on temporary trees and on
``src/repro_torch``; ``KNOWN_DEVIATIONS``' strictness; the whole 35-cell
matrix through ``run_audit(device="cpu")``. Against the reference (JAX
imported inside those tests only): the same protocol verdicts on the same
seeded dataset, a seeded violation of one kind failing both, and the same
JSON payload keys.

On the card (``cuda`` marker, skipped elsewhere): the trace rules on a
small flat step and a fused graph step, and a swap.
"""
import dataclasses
import json
import textwrap
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from repro_torch.analysis import assert_rules, registry, run
from repro_torch.analysis.protocol_rules import (BoundedCompileCache,
                                                 IdTranslationContract,
                                                 LeaflessAuxHostTier,
                                                 ProtocolContext,
                                                 ScorerSurface,
                                                 StaticConfigInTreedef,
                                                 TreedefStableIndexRefresh,
                                                 TreedefStableStreaming)
from repro_torch.analysis.source_rules import (NoHostSyncInStep as
                                               SourceNoHostSync,
                                               NoIsinstanceDispatch,
                                               SourceTree)
from repro_torch.analysis.trace_rules import (BufferPresent, LaunchBudget,
                                              NoDenseScoreMatrix,
                                              NoGatherOnFusedPath,
                                              NoHostSyncInStep, OpRecord,
                                              StepTrace, SwapCase,
                                              SwapWithoutCopy)

pytestmark = pytest.mark.tier1

M, N_DENSE = 4, 333        # odd n: no legitimate buffer collides


# ---------------------------------------------------------------------------
# Trace rules
# ---------------------------------------------------------------------------


def _dense_search(q, x):
    return torch.topk(q @ x.T, 3, dim=1)


@pytest.fixture(scope="module")
def dense_toy():
    """The seeded violation: dense (m, n) scoring then top-k."""
    g = torch.Generator().manual_seed(0)
    return StepTrace.of(_dense_search, torch.randn(M, 8, generator=g),
                        torch.randn(N_DENSE, 8, generator=g), label="toy")


def test_no_dense_score_matrix_fails_on_dense_toy(dense_toy):
    res = NoDenseScoreMatrix(M, N_DENSE).check(dense_toy)
    assert not res.passed and not res.skipped
    assert "f32[4,333]" in res.evidence and "aten.mm" in res.evidence
    with pytest.raises(AssertionError, match="NoDenseScoreMatrix"):
        assert_rules(dense_toy, [NoDenseScoreMatrix(M, N_DENSE)],
                     target="toy")
    # a (fn, *args) subject is traced by assert_rules itself
    x = torch.ones(N_DENSE, 8)
    with pytest.raises(AssertionError, match="f32\\[4,333\\]"):
        assert_rules((_dense_search, torch.ones(M, 8), x),
                     [NoDenseScoreMatrix(M, N_DENSE)])


def test_no_dense_score_matrix_passes_on_absent_shape(dense_toy):
    res = assert_rules(dense_toy, [NoDenseScoreMatrix(M, N_DENSE + 1)])
    assert res[0].passed and not res[0].skipped


def test_buffer_present_is_the_positive_twin(dense_toy):
    assert BufferPresent(M, N_DENSE).check(dense_toy).passed
    assert not BufferPresent(M, N_DENSE + 1).check(dense_toy).passed


def test_dense_buffer_inside_a_plain_version_skips_and_names_it():
    """On the CPU every kernel wrapper runs its plain version, which scores
    an (M, block) tile; the rule names it and skips (the card checks the
    kernel), and the positive twin still sees the buffer."""
    from repro_torch import kernels
    g = torch.Generator().manual_seed(1)
    q, x = torch.randn(M, 8, generator=g), torch.randn(N_DENSE, 8,
                                                       generator=g)
    trace = StepTrace.of(kernels.ip_topk, q, x, 5)
    res = NoDenseScoreMatrix(M, N_DENSE).check(trace)
    assert res.skipped and res.passed and "ip_topk_plain" in res.evidence
    assert BufferPresent(M, N_DENSE).check(trace).passed
    assert all(op.plain == "ip_topk_plain" for op in trace.ops
               if op.name.startswith("aten.mm"))


def test_buffer_present_on_the_dense_scoring_call():
    """``scorer_scores_prepared`` makes the dense (m, n) matrix for every
    scorer family: the rule the fused paths are measured against."""
    from repro_torch import kernels
    from repro_torch.core import scorer as sc
    from repro_torch.core import gleanvec as gv
    g = torch.Generator().manual_seed(2)
    x = torch.randn(300, 16, generator=g)
    q = torch.randn(40, 16, generator=g)
    model = gv.fit(q, x, c=3, d=4, kmeans_iters=3, generator=g,
                   device="cpu")
    for s in (sc.exact_scorer(x), sc.sorted_gleanvec_quantized_scorer(
            model, x, block=32)):
        qs = s.prepare_queries(q[:M])
        trace = StepTrace.of(kernels.scorer_scores_prepared, s, qs)
        assert BufferPresent(M, s.n_rows).check(trace).passed


def test_memory_bound_of_no_dense_score_matrix():
    """On a card the peak above the start must stay below rows*cols*4 B,
    whatever shape holds the bytes (a hand-made record: the CPU reports no
    peak)."""
    limit = M * N_DENSE * 4
    over = StepTrace([], device="cuda", syncs=0, peak_bytes=limit)
    res = NoDenseScoreMatrix(M, N_DENSE).check(over)
    assert not res.passed and "peak" in res.evidence
    under = StepTrace([], device="cuda", syncs=0, peak_bytes=limit - 512)
    assert NoDenseScoreMatrix(M, N_DENSE).check(under).passed
    # shapes alone, for a buffer no larger than the step's working set
    shapes = NoDenseScoreMatrix(M, N_DENSE, peak=False).check(over)
    assert shapes.passed and "peak" not in shapes.evidence


def _gather(x, idx):
    return x[idx]


def test_no_gather_fails_on_a_gather_over_budget():
    x, idx = torch.ones(64, 8), torch.arange(12)
    res = NoGatherOnFusedPath().check(StepTrace.of(_gather, x, idx))
    assert not res.passed and "aten.index.Tensor" in res.evidence
    assert "f32[12,8]=384B" in res.evidence
    # small gathers under an explicit byte budget are tolerated
    assert NoGatherOnFusedPath(max_bytes=1 << 20).check(
        StepTrace.of(_gather, x, idx)).passed


def test_no_gather_skips_inside_a_plain_version_naming_it():
    op = OpRecord("aten.index_select.default",
                  (((100, 8), torch.float32, "cpu"),), ((64, 8), (100,)),
                  plain="ivf_scan_topk_plain")
    res = NoGatherOnFusedPath(0).check(StepTrace([op]))
    assert res.skipped and res.passed
    assert "index_select" in res.evidence and "ivf_scan_topk_plain" in \
        res.evidence


def test_no_host_sync_in_step_is_a_card_rule(dense_toy):
    res = NoHostSyncInStep().check(dense_toy)
    assert res.skipped and "CUDA" in res.evidence
    op = OpRecord("aten._local_scalar_dense.default", (), ((),))
    bad = NoHostSyncInStep().check(StepTrace([op], device="cuda", syncs=2))
    assert not bad.passed and "2 synchronizing" in bad.evidence
    assert "_local_scalar_dense" in bad.evidence
    assert NoHostSyncInStep().check(
        StepTrace([], device="cuda", syncs=0)).passed


def test_launch_budget_caps_and_pins_kernels(dense_toy):
    assert LaunchBudget(4).check(dense_toy).skipped
    trace = StepTrace([], device="cuda", syncs=0, kernels={
        "graph_search_kernel": 1, "void at::native::elementwise": 10,
        "Memcpy DtoD": 1})
    pinned = {"graph_search_kernel": 1}
    assert LaunchBudget(12, exact=pinned).check(trace).passed
    over = LaunchBudget(11).check(trace)
    assert not over.passed and "12 device kernels over" in over.evidence
    loop = LaunchBudget(64, exact={"graph_search_kernel": 2}).check(trace)
    assert not loop.passed and "1 launches, not 2" in loop.evidence


# ---------------------------------------------------------------------------
# Protocol rules (one small context per module: the fits run once)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ctx():
    return ProtocolContext(n=256, D=16, d=4, c=2, m=8, sort_block=32,
                           seed=0, device="cpu")


def _engine_case(ctx, mode="gleanvec-int8-sorted"):
    from repro_torch.core import search as msearch
    from repro_torch.serve.engine import ServingEngine
    art = msearch.SearchArtifacts(scorer=ctx.scorer(mode), x_full=ctx.X,
                                  model=ctx.model_for(mode))
    state = msearch.make_state(art)
    engine = ServingEngine(run._clone(state), k=5, kappa=10,
                           batch_size=ctx.m, dim=ctx.D)
    return engine, run._clone(state)


def test_swap_without_copy_passes_on_the_engine(ctx):
    engine, new = _engine_case(ctx)
    res = SwapWithoutCopy().check(SwapCase(engine, new))
    assert res.passed and "displaced tensors freed" in res.evidence


def test_swap_without_copy_fails_on_a_copying_swap(ctx, monkeypatch):
    from repro_torch.serve.engine import ServingEngine
    orig = ServingEngine.swap

    def copying(self, state):
        orig(self, run._clone(state))

    monkeypatch.setattr(ServingEngine, "swap", copying)
    engine, new = _engine_case(ctx)
    res = SwapWithoutCopy().check(SwapCase(engine, new))
    assert not res.passed and "not the new state's tensors" in res.evidence


def test_swap_without_copy_fails_when_the_old_state_leaks(ctx,
                                                          monkeypatch):
    from repro_torch.serve.engine import ServingEngine
    orig, kept = ServingEngine.swap, []

    def leaky(self, state):
        kept.append(self.state)       # a stray reference to the old state
        orig(self, state)

    monkeypatch.setattr(ServingEngine, "swap", leaky)
    engine, new = _engine_case(ctx)
    res = SwapWithoutCopy().check(SwapCase(engine, new))
    assert not res.passed and "still alive" in res.evidence


@pytest.mark.parametrize("mode", ["full", "gleanvec", "gleanvec-sorted",
                                  "gleanvec-int8-sorted"])
def test_protocol_rules_pass_on_real_scorers(ctx, mode):
    assert_rules(ctx, [ScorerSurface(mode), IdTranslationContract(mode),
                       TreedefStableStreaming(mode)])


def test_protocol_rules_pass_on_indices_and_host_tier(ctx):
    res = assert_rules(ctx, [TreedefStableIndexRefresh("flat"),
                             TreedefStableIndexRefresh("ivf"),
                             TreedefStableIndexRefresh("graph"),
                             TreedefStableIndexRefresh("sharded"),
                             LeaflessAuxHostTier(),
                             StaticConfigInTreedef("ivf", "nprobe"),
                             StaticConfigInTreedef("graph", "beam"),
                             BoundedCompileCache()])
    assert not any(r.skipped for r in res)


def test_static_config_flat_block_skips_without_inventing_a_field(ctx):
    res = StaticConfigInTreedef("flat", "block").check(ctx)
    assert res.skipped and res.passed
    assert "FlatIndex has no 'block' field" in res.evidence


class _StubCtx:
    """Duck-typed ProtocolContext carrying one (broken) scorer."""

    def __init__(self, scorer):
        self._scorer = scorer
        self.device = torch.device("cpu")

    def scorer(self, mode):
        return self._scorer


class _BadIdScorer:
    n_rows = 8

    def translate_ids(self, ids):
        return ids.abs()             # -1 NOT kept inert

    def globalize_ids(self, ids, shard_idx):
        return ids.abs()


def test_id_translation_fails_on_seeded_violation():
    res = IdTranslationContract("stub").check(_StubCtx(_BadIdScorer()))
    assert not res.passed and "-1" in res.evidence


def test_id_translation_fails_when_the_kernel_returns_sorted_slots(
        ctx, monkeypatch):
    """A lowering that forgets ``row_ids=perm`` returns sorted-row slots:
    the layout's slot count is past the original id space."""
    from repro_torch import kernels

    def slots(scorer, qstate, k):
        return kernels.gleanvec_sq_topk(
            qstate.q_scaled, qstate.q_lo, scorer.block_tags, scorer.codes,
            k, layout_block=scorer.layout_block)

    monkeypatch.setattr(kernels, "scorer_topk_prepared", slots)
    res = IdTranslationContract("gleanvec-int8-sorted").check(ctx)
    assert not res.passed and "ids outside [-1, 256)" in res.evidence


def test_scorer_surface_fails_on_missing_methods(monkeypatch, ctx):
    from repro_torch.core import scorer as sc
    res = ScorerSurface("stub").check(_StubCtx(_BadIdScorer()))
    assert not res.passed and "score_ids" in res.evidence
    monkeypatch.delattr(sc.LinearScorer, "score_block")
    res = ScorerSurface("full").check(ctx)
    assert not res.passed and "['score_block']" in res.evidence


def test_treedef_streaming_fails_on_seeded_aval_change(ctx, monkeypatch):
    from repro_torch.core import streaming

    def chopping_insert(art, rows, ids=None):
        return art._replace(x_full=art.x_full[:-1]), torch.tensor([0])

    monkeypatch.setattr(streaming, "insert_rows", chopping_insert)
    res = TreedefStableStreaming("full").check(ctx)
    assert not res.passed and "aval" in res.evidence


def test_treedef_index_refresh_fails_on_seeded_retype(ctx, monkeypatch):
    from repro_torch.index.ivf import IVFIndex

    monkeypatch.setattr(
        IVFIndex, "refreshed",
        lambda self, scorer, model: dataclasses.replace(
            self, nprobe=self.nprobe * 2))
    res = TreedefStableIndexRefresh("ivf").check(ctx)
    assert not res.passed and "treedef changed" in res.evidence


@dataclass(frozen=True, eq=False)
class _LeakyIndex:
    """Deliberately WRONG: config held as a tensor, i.e. a data leaf."""

    nprobe: torch.Tensor


def test_static_config_fails_on_config_leaked_into_leaves(ctx):
    res = StaticConfigInTreedef(lambda _ctx: _LeakyIndex(torch.tensor(8)),
                                "nprobe").check(ctx)
    assert not res.passed and "kept the structure" in res.evidence


def test_bounded_compile_cache_fails_on_stray_dispatch(ctx, monkeypatch):
    from repro_torch.serve.frontend import ServingFrontend

    # seeded violation: dispatch the RAW request count instead of the
    # smallest covering bucket -- odd-size batches stray off the static
    # shape set (and each stray shape is one more batch shape served)
    monkeypatch.setattr(ServingFrontend, "_pick_bucket",
                        lambda self, n: n)
    res = BoundedCompileCache().check(ctx)
    assert not res.passed and "buckets" in res.evidence


def test_leafless_host_tier_fails_on_leafy_store(ctx, monkeypatch):
    from repro_torch.core import rerank_tier

    monkeypatch.setattr(rerank_tier, "demote",
                        lambda x, shards=0: (x.clone(),))
    monkeypatch.setattr(rerank_tier, "promote", lambda s, device: s[0])
    res = LeaflessAuxHostTier().check(ctx)
    assert not res.passed and "leaves" in res.evidence


# ---------------------------------------------------------------------------
# Source rules (violations seeded into a temp tree)
# ---------------------------------------------------------------------------


def _tree(tmp_path, rel, body):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(body))
    return SourceTree(str(tmp_path))


def test_no_isinstance_dispatch_fails_on_hot_path_and_respects_waiver(
        tmp_path):
    body = """\
        def pick(s):
            if isinstance(s, (int, SortedGleanVecScorer)):
                return 1
            return 0
    """
    res = NoIsinstanceDispatch().check(_tree(tmp_path / "hot",
                                             "index/x.py", body))
    assert not res.passed and "index/x.py:2" in res.evidence
    assert "SortedGleanVecScorer" in res.evidence
    # the same construct OUTSIDE a hot path (the lowering) is not this
    # rule's business
    assert NoIsinstanceDispatch().check(
        _tree(tmp_path / "cold", "kernels/__init__.py", body)).passed
    waived = body.replace("Scorer)):", "Scorer)):  # analysis: "
                          "allow-isinstance")
    assert NoIsinstanceDispatch().check(
        _tree(tmp_path / "waived", "index/x.py", waived)).passed


STEPS = {"core/search.py": ("state_search", "state_candidates"),
         "index/protocol.py": ("FlatIndex.candidates",)}


def test_source_no_host_sync_in_step_fails_in_declared_bodies(tmp_path):
    _tree(tmp_path, "index/protocol.py", """\
        class FlatIndex:
            def candidates(self, q, s, k):
                torch.cuda.synchronize()
                return q.tolist()

            def refreshed(self, s, m):
                return m.item()             # not a declared step
    """)
    tree = _tree(tmp_path, "core/search.py", """\
        import numpy as np

        def state_search(q, state, k, kappa):
            n = state.count.item()
            return np.asarray(q.cpu().numpy())

        def state_candidates(q, state, kappa):
            return helper(q)

        def helper(q):
            return q.item()                 # fine: a callee
    """)
    res = SourceNoHostSync(STEPS).check(tree)
    assert not res.passed
    for frag in ("core/search.py:4: .item() host sync in step state_search",
                 "np.asarray", ".cpu()", ".numpy()",
                 "torch.cuda.synchronize", ".tolist()"):
        assert frag in res.evidence
    assert "helper" not in res.evidence and "refreshed" not in res.evidence


def test_source_no_host_sync_in_step_waiver_and_missing_steps(tmp_path):
    tree = _tree(tmp_path, "core/search.py", """\
        def state_search(q, state, k, kappa):
            return q.item()  # analysis: allow-host-sync

        def state_candidates(q, state, kappa):
            return q
    """)
    res = SourceNoHostSync(STEPS).check(tree)
    # the waiver holds; the declared FlatIndex.candidates is missing
    assert not res.passed and ".item()" not in res.evidence
    assert "declared step function FlatIndex.candidates not found" in \
        res.evidence
    assert SourceNoHostSync({"core/search.py": STEPS["core/search.py"]}) \
        .check(tree).passed


def test_repo_tree_is_lint_clean():
    """The shipped port starts green under its own lint."""
    results = run.run_lint()
    assert [r.rule for r in results] == ["NoIsinstanceDispatch",
                                         "NoHostSyncInStep"]
    assert all(r.passed and not r.skipped for r in results), results


# ---------------------------------------------------------------------------
# run.py: KNOWN_DEVIATIONS' strictness and the whole matrix
# ---------------------------------------------------------------------------


def _res(target, rule, passed, skipped=False):
    return registry.RuleResult(rule, target, passed, "", skipped, "trace")


def test_known_deviations_are_strict_both_ways():
    known = {("graph/full", "NoHostSyncInStep"): "ROADMAP C x"}
    results = [_res("graph/full", "NoHostSyncInStep", False),
               _res("flat/full", "NoHostSyncInStep", True)]
    assert run.verdict(results, known) == ([], [])
    # a listed entry that passes where it was evaluated fails the audit
    fixed = [_res("graph/full", "NoHostSyncInStep", True)]
    assert run.verdict(fixed, known) == \
        ([], [("graph/full", "NoHostSyncInStep")])
    # a skipped evaluation (the CPU) neither confirms nor refutes it
    assert run.verdict([_res("graph/full", "NoHostSyncInStep", True,
                             skipped=True)], known) == ([], [])
    # an unlisted failure fails the audit
    bad = [_res("ivf/full", "NoHostSyncInStep", False)]
    assert run.verdict(bad, known)[0] == bad


def test_run_audit_fails_on_a_listed_entry_that_passes(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(run, "KNOWN_DEVIATIONS", {
        ("gleanvec", "ScorerSurface"): "a stale listing"})
    report = run.run_audit(out=None, device="cpu", skip_trace=True,
                           log=lambda msg: None)
    assert report.code == 1 and not report.unlisted
    assert report.stale == [("gleanvec", "ScorerSurface")]


def test_audit_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                      monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.run_audit(log=lambda msg: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProtocolContext(n=64, D=8, d=2, c=2, m=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["audit"])
    assert not list(tmp_path.iterdir())      # nothing written


def test_whole_matrix_audit_on_the_cpu(tmp_path):
    out = tmp_path / "ANALYSIS_torch.json"
    lines = []
    report = run.run_audit(out=str(out), device="cpu", log=lines.append)
    assert report.code == 0, "\n".join(lines)
    payload = json.loads(out.read_text())
    assert payload["matrix"]["cells"] == 35 and len(report.cells) == 35
    assert payload["device"] == "cpu" and payload["unlisted_failures"] == 0
    from repro_torch.core.scorer import MODES
    targets = {r["target"] for r in payload["results"]}
    for mode in MODES:
        for topo in run.TOPOLOGIES:
            assert f"{topo}/{mode}" in targets
    assert {r["family"] for r in payload["results"]} == \
        {"source", "protocol", "trace"}
    # no contract is listed as broken (ROADMAP C 4 closed): every graph
    # cell, gathered or fused, carries the one-traversal-launch budget
    assert run.KNOWN_DEVIATIONS == {} and payload["known_deviations"] == []
    for mode in MODES:
        rules = {r["rule"] for r in payload["results"]
                 if r["target"] == f"graph/{mode}"}
        assert {"NoHostSyncInStep", "LaunchBudget",
                "NoDenseScoreMatrix"} <= rules, (mode, rules)
    # every card-only reading skipped, saying why; nothing failed
    assert payload["counts"]["failed"] == 0
    for r in payload["results"]:
        if r["rule"] in ("NoHostSyncInStep", "LaunchBudget") and \
                r["family"] == "trace":
            assert r["skipped"] and "CUDA" in r["evidence"]


# ---------------------------------------------------------------------------
# Against the reference (JAX inside these tests only)
# ---------------------------------------------------------------------------


PARITY_MODES = ("full", "gleanvec", "gleanvec-sorted",
                "gleanvec-int8-sorted")


def _verdicts(results):
    return [(r.rule, r.target, r.passed, r.skipped) for r in results]


@pytest.fixture(scope="module")
def ref_ctx():
    from repro.analysis.protocol_rules import ProtocolContext as RefContext
    return RefContext(n=256, D=16, d=4, c=2, m=8, sort_block=32, seed=0)


def test_protocol_verdicts_match_the_reference(ctx, ref_ctx):
    from repro.analysis import protocol_rules as ref
    from repro.analysis import registry as ref_registry
    from repro_torch.analysis import protocol_rules as port

    def rules(mod):
        out = []
        for mode in PARITY_MODES:
            out += [mod.ScorerSurface(mode), mod.IdTranslationContract(mode),
                    mod.TreedefStableStreaming(mode)]
        return out + [mod.TreedefStableIndexRefresh("flat"),
                      mod.LeaflessAuxHostTier(), mod.BoundedCompileCache(),
                      mod.StaticConfigInTreedef("ivf", "nprobe")]

    got = registry.run_rules(ctx, rules(port))
    want = ref_registry.run_rules(ref_ctx, rules(ref))
    assert _verdicts(got) == _verdicts(want)
    assert all(r.passed and not r.skipped for r in got)
    # the stated difference: the reference's FlatIndex has a ``block``
    # field, the port's none
    assert ref.StaticConfigInTreedef("flat", "block").check(ref_ctx).passed
    assert port.StaticConfigInTreedef("flat", "block").check(ctx).skipped
    # both payloads have the same keys, top level and rows
    p = registry.results_to_json(got)
    r = ref_registry.results_to_json(want)
    assert p.keys() == r.keys()
    assert p["results"][0].keys() == r["results"][0].keys()


def test_seeded_violations_fail_the_reference_and_the_port(ctx, ref_ctx,
                                                           monkeypatch):
    import jax.numpy as jnp
    from repro.analysis import protocol_rules as ref
    from repro.core import rerank_tier as ref_tier
    from repro_torch.core import rerank_tier

    class _RefBad:
        n_rows = 8

        def translate_ids(self, ids):
            return jnp.abs(ids)

        def globalize_ids(self, ids, shard_idx):
            return jnp.abs(ids)

    class _RefStub:
        def scorer(self, mode):
            return _RefBad()

    for res in (ref.IdTranslationContract("stub").check(_RefStub()),
                IdTranslationContract("stub").check(_StubCtx(
                    _BadIdScorer()))):
        assert not res.passed and "translate_ids(-1) -> 1" in res.evidence

    monkeypatch.setattr(ref_tier, "demote",
                        lambda x, shards=0: (jnp.asarray(x),))
    monkeypatch.setattr(ref_tier, "promote", lambda s: s[0])
    monkeypatch.setattr(rerank_tier, "demote",
                        lambda x, shards=0: (x.clone(),))
    monkeypatch.setattr(rerank_tier, "promote", lambda s, device: s[0])
    for res in (ref.LeaflessAuxHostTier().check(ref_ctx),
                LeaflessAuxHostTier().check(ctx)):
        assert not res.passed and "has 1 leaves" in res.evidence


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_trace_rules_on_flat_and_fused_graph_steps(cuda):
    """A small flat step and a fused graph step on the card: no dense
    (m, n) buffer and a peak below its bytes, no host sync, the launch
    budget, and the whole traversal one ``graph_search_kernel``."""
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import scorer as sc
    from repro_torch.core import search as msearch
    from repro_torch.index import graph

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4000, 32, device=cuda, generator=g)
    q = torch.randn(300, 32, device=cuda, generator=g)
    model = gv.fit(q, x, c=6, d=16, kmeans_iters=4, generator=g, device=cuda)
    s = sc.sorted_gleanvec_quantized_scorer(model, x, block=64)
    art = msearch.SearchArtifacts(scorer=s, x_full=x, model=model)
    qb = q[:64]
    flat = StepTrace.of(msearch.state_candidates, qb,
                        msearch.make_state(art), 20, label="flat")
    assert flat.syncs is not None and flat.kernels
    assert_rules(flat, [NoDenseScoreMatrix(64, s.n_rows),
                        NoHostSyncInStep(), LaunchBudget(run.STEP_LAUNCHES),
                        NoGatherOnFusedPath(64 * 20 * 32 * 4)],
                 target="flat")
    # beam 40: no legitimate (64, beam) buffer takes the forbidden
    # (64, expand * degree) = (64, 32) shape
    fg = dataclasses.replace(graph.with_fused_scan(
        graph.build(x, r=12, n_iters=2, device=cuda), s), beam=40,
        max_hops=64, expand=2)
    walk = StepTrace.of(msearch.state_candidates, qb,
                        msearch.make_state(art, index=fg), 20, label="graph")
    assert_rules(walk, [NoDenseScoreMatrix(64, s.n_rows),
                        NoDenseScoreMatrix(64, 2 * fg.neighbors.shape[1],
                                           peak=False),
                        NoHostSyncInStep(),
                        LaunchBudget(run.STEP_LAUNCHES,
                                     exact={run.TRAVERSAL_KERNEL: 1})],
                 target="graph")
    # a swap installs the new state's tensors and frees the old ones
    from repro_torch.serve.engine import ServingEngine
    state = msearch.make_state(art)
    engine = ServingEngine(run._clone(state), k=10, kappa=20,
                           batch_size=64, dim=32)
    res = SwapWithoutCopy().check(SwapCase(engine, run._clone(state)))
    assert res.passed and "memory_allocated fell by" in res.evidence, res
    # the positive twin on the dense scoring call, through the kernel
    from repro_torch import kernels
    dense = StepTrace.of(kernels.scorer_scores_prepared, s,
                         s.prepare_queries(qb))
    assert BufferPresent(64, s.n_rows).check(dense).passed
    assert not NoDenseScoreMatrix(64, s.n_rows).check(dense).passed
