"""Rules the PyTorch port keeps.

* No module of ``repro_torch``, not ``chip_smoke.py`` and no
  ``examples/torch_*.py`` imports JAX or anything of the JAX package
  (checked on the source with ``ast``, and by importing the port in a
  fresh interpreter).
* Entry points run on the GPU by default and raise, rather than carry on
  on the CPU, when there is none; so do the examples without ``--device
  cpu``.
* A kernel wrapper given CUDA tensors launches its kernel and never takes
  the plain path (``cuda`` marker: needs a GPU, skipped elsewhere).
* ``chip_smoke.py`` exits non-zero and prints no result without a GPU or
  without the repository beside it.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "examples").glob("torch_*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_without_jax():
    code = ("import sys\n"
            "import repro_torch, repro_torch.kernels, repro_torch.convert\n"
            "import repro_torch.testing, repro_torch.launch.serve\n"
            "import repro_torch.serve.engine, repro_torch.index.protocol\n"
            "import repro_torch.index.ivf, repro_torch.kernels.ivf_scan\n"
            "import repro_torch.core.streaming, repro_torch.kernels.sq_dot\n"
            "import repro_torch.kernels.gleanvec_ip\n"
            "import repro_torch.index.graph, repro_torch.kernels.graph_scan\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.models.transformer, repro_torch.serve.decode\n"
            "import repro_torch.configs.registry\n"
            "import repro_torch.tree, repro_torch.core.rerank_tier\n"
            "import repro_torch.serve.lifecycle, repro_torch.serve.faults\n"
            "import repro_torch.serve.frontend, repro_torch.train.checkpoint\n"
            "import repro_torch.index.distributed\n"
            "import repro_torch.analysis, repro_torch.analysis.run\n"
            "import repro_torch.analysis.trace_rules\n"
            "import repro_torch.core.baselines, repro_torch.index.bruteforce\n"
            "import repro_torch.models.recsys, repro_torch.models.embedding\n"
            "import repro_torch.serve.retrieval, repro_torch.train.data\n"
            "import repro_torch.configs.gleanvec_paper\n"
            "import repro_torch.models.moe, repro_torch.configs.grok1_314b\n"
            "import repro_torch.configs.llama4_maverick\n"
            "import repro_torch.train, repro_torch.train.optimizer\n"
            "import repro_torch.train.trainstep, repro_torch.train.grad_compress\n"
            "import repro_torch.launch.steps, repro_torch.launch.train\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.report\n"
            "import repro_torch.utils.roofline\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules), 'repro was imported'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    from repro_torch import resolve_device
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import leanvec_sphering as lvs
    from repro_torch.core import search
    from repro_torch.core.scorer import build_scorer
    from repro_torch.index import graph, ivf
    from repro_torch.launch import serve
    x = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    model = gv.GleanVecModel(centers=torch.eye(2, 8), a=torch.zeros(2, 4, 8),
                             b=torch.zeros(2, 4, 8), w=torch.eye(8),
                             w_pinv=torch.eye(8))
    from repro_torch.core import streaming
    from repro_torch import convert
    from repro_torch.index import bruteforce
    from repro_torch.serve import retrieval
    from repro_torch.train import data
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import decode
    from repro_torch.models import layers, recsys
    mind_cfg = registry.get("mind").make_config(smoke=True)
    dlrm_cfg = registry.get("dlrm-mlperf").make_config(smoke=True)
    lm_cfg = registry.get("h2o-danube-3-4b").make_config(smoke=True)
    lm_params = tfm.init(lm_cfg, device="cpu")
    from repro_torch.models import moe
    moe_cfg = registry.get("grok-1-314b").make_config(smoke=True)
    from repro_torch.launch import dryrun, steps, train
    from repro_torch.models import gnn
    gcn_cfg = registry.get("gcn-cora").make_config(smoke=True)

    def numpy_tree(t):
        if isinstance(t, dict):
            return {k: numpy_tree(v) for k, v in t.items()}
        return t.numpy()

    lm_tree = numpy_tree(lm_params)
    calls = [lambda: resolve_device(),
             lambda: tfm.init(lm_cfg),
             lambda: tfm.init_cache(lm_cfg, 1, 8),
             lambda: tfm.init(moe_cfg),
             lambda: moe.moe_init(64, 128, moe_cfg.moe, True,
                                  torch.float32, torch.Generator()),
             lambda: convert.transformer_params(lm_tree, lm_cfg),
             lambda: decode.generate(lm_params, np.zeros((1, 4), np.int64),
                                     2, lm_cfg),
             lambda: streaming.build_streaming_artifacts("full", x),
             lambda: serve.main(["--n", "100", "--dim", "8", "--d", "4",
                                 "--stream"]),
             lambda: ivf.build(x, 2),
             lambda: graph.build(x, r=4),
             lambda: serve.main(["--n", "100", "--dim", "8", "--d", "4",
                                 "--mode", "gleanvec-sorted", "--index",
                                 "graph", "--fused-graph"]),
             lambda: ivf.build_aligned(model, x),
             lambda: serve.main(["--n", "100", "--dim", "8", "--d", "4",
                                 "--mode", "gleanvec-sorted", "--index",
                                 "ivf", "--aligned"]),
             lambda: resolve_device("cuda"),
             lambda: build_scorer("full", x),
             lambda: search.build_artifacts("full", x),
             lambda: lvs.fit(x, x, 4),
             lambda: gv.fit(x, x, c=2, d=4),
             lambda: retrieval.build_retrieval_index(x, "full"),
             lambda: retrieval.build_retrieval_index(x, "gleanvec", model),
             lambda: bruteforce.search(x[:2], x, 3),
             lambda: bruteforce.search_gleanvec(
                 np.zeros((2, 2, 4), np.float32), np.zeros(64, np.int32),
                 x[:, :4], 3),
             lambda: bruteforce.search_gleanvec_sorted(
                 np.zeros((2, 2, 4), np.float32), np.zeros(1, np.int32),
                 x[:, :4], 3),
             lambda: bruteforce.search_quantized(
                 x[:2, :4], np.zeros((64, 4), np.uint8), np.zeros(4),
                 np.ones(4), 3),
             lambda: data.criteo_batch(0, 0, 4, 13, (5, 7)),
             lambda: data.bst_batch(0, 0, 4, 20, 100),
             lambda: data.mind_batch(0, 0, 4, 50, 100),
             lambda: recsys.mind.init(torch.Generator(), mind_cfg),
             lambda: recsys.dlrm.init(torch.Generator(), dlrm_cfg),
             lambda: layers.mlp_init(torch.Generator(), (4, 8, 1)),
             lambda: layers.embed_init(torch.Generator(), 8, 4),
             lambda: data.lm_batch(0, 0, 2, 8, 100),
             lambda: steps.build_bundle("h2o-danube-3-4b", "train_4k",
                                        smoke=True),
             lambda: train.main(["--arch", "h2o-danube-3-4b", "--smoke",
                                 "--steps", "1"]),
             lambda: train.main(["--arch", "mind", "--shape", "train_batch",
                                 "--smoke", "--steps", "1"]),
             lambda: gnn.init(gcn_cfg),
             lambda: data.gnn_graph(0, 10, 8, 4, 3),
             lambda: data.molecule_batch(0, 0, 2, 5, 4, 3, 1),
             lambda: data.graph_minibatch_seeds(0, 0, 4, 10),
             lambda: steps.build_bundle("gcn-cora", "molecule", smoke=True),
             lambda: steps.build_bundle("h2o-danube-3-4b", "prefill_32k",
                                        smoke=True),
             lambda: steps.build_bundle("h2o-danube-3-4b", "decode_32k",
                                        smoke=True),
             lambda: steps.build_bundle("mind", "serve_p99", smoke=True),
             lambda: steps.build_bundle("dlrm-mlperf", "retrieval_cand",
                                        smoke=True),
             lambda: steps.build_bundle("gleanvec-paper", "learn_oi13m",
                                        smoke=True),
             lambda: steps.build_bundle("gleanvec-paper",
                                        "search_oi13m_sorted", smoke=True),
             lambda: train.main(["--arch", "gcn-cora", "--shape",
                                 "minibatch_lg", "--smoke", "--steps", "1"]),
             lambda: dryrun.run_cell("gleanvec-paper", "search_oi13m",
                                     "single", smoke=True),
             lambda: dryrun.main(["--arch", "fm", "--shape", "serve_p99"]),
             lambda: serve.main(["--n", "100", "--dim", "8", "--d", "4"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", ["quickstart", "serve_vector_search",
                                  "streaming_updates",
                                  "train_recsys_retrieval"])
def test_examples_need_a_gpu_or_device_cpu(name):
    """Each ``examples/torch_*.py`` runs on the GPU by default and raises
    without one, before any work (``--device cpu``:
    ``tests/test_torch_examples.py``)."""
    import importlib.util
    _no_cuda()
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_recsys_init_refuses_a_generator_on_another_device():
    from repro_torch.configs import registry
    from repro_torch.models import layers, recsys
    cfg = registry.get("fm").make_config(smoke=True)
    with pytest.raises(ValueError, match="generator"):
        recsys.fm.init(torch.Generator(), cfg, device="meta")
    with pytest.raises(ValueError, match="generator"):
        layers.dense_init(torch.Generator(), 4, 2, device="meta")
    p = recsys.fm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert p["v"].device == torch.device("cpu")


def test_wrappers_refuse_mixed_devices():
    from repro_torch import kernels as K
    q = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="devices"):
        K.ip_topk(q, torch.zeros(3, 4), 1)
    with pytest.raises(ValueError, match="devices"):
        K.kmeans_assign(torch.zeros(3, 4), torch.empty(2, 4, device="meta"))


def test_library_path_tracks_sources():
    """Libraries are named by a digest of their sources, under the
    git-ignored build directory."""
    from repro_torch import kernels as K
    paths = {name: K.library_path(name) for name in K.KERNEL_SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, p in paths.items():
        assert p.parent == K.BUILD_DIR and p.name.startswith(name + "-")
        assert p == K.library_path(name)
    assert "build/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(alone, tmp_path):
    if alone:
        script = tmp_path / "chip_smoke.py"
        shutil.copy(ROOT / "chip_smoke.py", script)
    else:
        _no_cuda()
        script = ROOT / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_wrappers_launch_kernels_not_plain(cuda, monkeypatch):
    import importlib

    from repro_torch import kernels as K

    # the kernel modules by name: ``import repro_torch.kernels.ip_topk as
    # m`` binds the package attribute, which is the wrapper function that
    # ``kernels/__init__.py`` imports under the module's own name
    gip, gsq, ipk, kma, sqd = (
        importlib.import_module(f"repro_torch.kernels.{name}")
        for name in ("gleanvec_ip", "gleanvec_sq", "ip_topk",
                     "kmeans_assign", "sq_dot"))

    def refuse(*a, **k):
        raise AssertionError("plain path taken for a CUDA tensor")

    for mod, name in ((ipk, "ip_topk_plain"), (gsq, "gleanvec_sq_topk_plain"),
                      (kma, "kmeans_assign_plain"),
                      (gsq, "gleanvec_sq_plain"), (gip, "gleanvec_ip_plain"),
                      (sqd, "sq_dot_folded_plain")):
        monkeypatch.setattr(mod, name, refuse)
    before = (K.ip_topk.launches, K.gleanvec_sq_topk.launches,
              K.kmeans_assign.launches, K.sq_dot.launches,
              K.gleanvec_ip.launches, K.gleanvec_sq.launches)
    K.ip_topk(torch.randn(5, 16, device=cuda), torch.randn(300, 16,
                                                           device=cuda), 10)
    K.gleanvec_sq_topk(torch.randn(5, 3, 16, device=cuda),
                       torch.zeros(5, 3, device=cuda),
                       torch.zeros(300, dtype=torch.int32, device=cuda),
                       torch.randn(300, 16, device=cuda), 10)
    K.kmeans_assign(torch.randn(300, 16, device=cuda),
                    torch.randn(4, 16, device=cuda))
    K.sq_dot(torch.randn(5, 16, device=cuda),
             torch.zeros(300, 16, dtype=torch.uint8, device=cuda),
             torch.zeros(16, device=cuda), torch.ones(16, device=cuda))
    K.gleanvec_ip(torch.randn(5, 3, 16, device=cuda),
                  torch.zeros(300, dtype=torch.int32, device=cuda),
                  torch.randn(300, 16, device=cuda))
    K.gleanvec_sq(torch.randn(5, 3, 16, device=cuda),
                  torch.zeros(5, 3, device=cuda),
                  torch.zeros(3, dtype=torch.int32, device=cuda),
                  torch.randn(300, 16, device=cuda), layout_block=100)
    torch.cuda.synchronize()
    after = (K.ip_topk.launches, K.gleanvec_sq_topk.launches,
             K.kmeans_assign.launches, K.sq_dot.launches,
             K.gleanvec_ip.launches, K.gleanvec_sq.launches)
    assert after == tuple(b + 1 for b in before)


@pytest.mark.cuda
def test_cuda_custom_ops_launch_kernels_not_plain(cuda, monkeypatch):
    """B1, B3 and B9 are the custom ops ``repro_torch::gleanvec_sq_topk``,
    ``::kmeans_assign`` and ``::flash_attention``: on CUDA tensors the
    wrapper and the op alike launch the hand-written kernel (one launch
    each, counted) and never the plain version; on fake CUDA tensors (the
    dry run) the op gives its output shapes and its flop count, and
    launches nothing."""
    import importlib

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels as K
    mods = {name: importlib.import_module(f"repro_torch.kernels.{name}")
            for name in ("gleanvec_sq", "kmeans_assign", "flash_attention")}

    def refuse(*a, **k):
        raise AssertionError("plain path taken for a CUDA tensor")

    for name, plain in (("gleanvec_sq", "gleanvec_sq_topk_plain"),
                        ("kmeans_assign", "kmeans_assign_plain"),
                        ("flash_attention", "flash_attention_plain")):
        monkeypatch.setattr(mods[name], plain, refuse)

    def args(dev, fake: bool):
        if fake:
            def mk(*s, **k):
                return torch.empty(*s, device=dev, **k)
        else:
            g = torch.Generator(device=dev).manual_seed(0)

            def mk(*s, **k):
                return torch.randn(*s, device=dev, generator=g, **k)
        return ((mk(5, 3, 16), torch.zeros(5, 3, device=dev),
                 torch.zeros(300, dtype=torch.int32, device=dev),
                 mk(300, 16), 10),
                (mk(300, 16), mk(4, 16)),
                (mk(2, 4, 200, 128, dtype=torch.bfloat16),
                 mk(2, 2, 200, 128, dtype=torch.bfloat16),
                 mk(2, 2, 200, 128, dtype=torch.bfloat16), True, 64))

    wrappers = (K.gleanvec_sq_topk, K.kmeans_assign, K.flash_attention)
    ops = (torch.ops.repro_torch.gleanvec_sq_topk,
           torch.ops.repro_torch.kmeans_assign,
           torch.ops.repro_torch.flash_attention)
    before = [w.launches for w in wrappers]
    b1, b3, b9 = args(cuda, fake=False)
    K.gleanvec_sq_topk(*b1)
    ops[0](*b1, None, 0)
    K.kmeans_assign(*b3)
    ops[1](*b3)
    K.flash_attention(*b9)
    ops[2](*b9)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [b + 2 for b in before]
    with FakeTensorMode():
        f1, f3, f9 = args("cuda", fake=True)
        with FlopCounterMode(display=False) as fc:
            (v, i), (t, m), o = (K.gleanvec_sq_topk(*f1),
                                 K.kmeans_assign(*f3), K.flash_attention(*f9))
    assert (v.shape, i.dtype, t.shape, o.shape) == (
        (5, 10), torch.int32, (300,), (2, 4, 200, 128))
    counts = fc.get_flop_counts()["Global"]
    assert counts[ops[0]] == 2 * 5 * 300 * 16
    assert counts[ops[1]] == 2 * 300 * 4 * 16
    pairs = mods["flash_attention"].attention_pairs(200, True, 64)
    assert counts[ops[2]] == 4 * 128 * 2 * 4 * pairs
    assert [w.launches for w in wrappers] == [b + 2 for b in before]


@pytest.mark.cuda
def test_cuda_ivf_scan_launches_kernel_not_plain(cuda, monkeypatch):
    """An aligned IVF search on the card lowers its fine step to the
    ``ivf_scan_topk`` kernel (one launch per search, never the plain
    version), and the result agrees with the plain version on the same
    inputs."""
    import repro_torch.kernels.ivf_scan as ivs
    from repro_torch import kernels as K
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import scorer as sc
    from repro_torch.index import ivf
    from repro_torch.testing import assert_topk_close, dot_tol
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3000, 32, device=cuda, generator=g)
    q = torch.randn(40, 32, device=cuda, generator=g)
    model = gv.fit(q, x, c=6, d=8, kmeans_iters=4, generator=g, device=cuda)
    s = sc.sorted_gleanvec_quantized_scorer(model, x, block=64,
                                            slack_blocks=1)
    idx = ivf.with_reduced_centers(
        ivf.build_aligned(model, x, nprobe=3, device=cuda), s, model)
    qstate = s.prepare_queries(q)
    probe = torch.sort(ivf.coarse_scores(idx, ivf.IVFQueryState(qstate, None)),
                       dim=1, descending=True, stable=True).indices[:, :3]
    sched = s.list_block_ranges[probe].reshape(40, -1)
    args = (qstate.q_scaled, qstate.q_lo, s.block_tags, s.perm, s.codes,
            sched, 100, s.layout_block)
    plain = ivs.ivf_scan_topk_plain(*args)

    def refuse(*a, **k):
        raise AssertionError("plain path taken for a CUDA tensor")

    monkeypatch.setattr(ivs, "ivf_scan_topk_plain", refuse)
    before = K.ivf_scan_topk.launches
    got = idx.search(q, s, 100)
    torch.cuda.synchronize()
    assert K.ivf_scan_topk.launches == before + 1
    tol = dot_tol(float(qstate.q_scaled.norm(dim=-1).max()),
                  float(s.codes.float().norm(dim=1).max()), 8,
                  float(qstate.q_lo.abs().max()))
    assert_topk_close(got, plain, tol, "ivf_scan_topk vs plain")
    assert_topk_close(K.ivf_scan_topk(*args), plain, tol, "direct")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda):
    from repro_torch import kernels as K
    from repro_torch.testing import assert_topk_close, dot_tol
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(70, 48, device=cuda, generator=g)
    x = torch.randn(3001, 48, device=cuda, generator=g)
    tol = dot_tol(float(q.norm(dim=1).max()), float(x.norm(dim=1).max()), 48)
    assert_topk_close(K.ip_topk(q, x, 100), K.ip_topk_plain(q, x, 100), tol,
                      "ip_topk")


@pytest.mark.cuda
def test_cuda_graph_hop_launches_kernel_not_plain(cuda, monkeypatch):
    """A fused graph search on the card runs the whole traversal as one
    ``graph_beam_search`` launch (never a plain version, never the per-hop
    kernel), the gathered search launches neither, the fused search equals
    the gathered traversal, and the per-hop kernel agrees with its plain
    version on a hop with pads, repeats and dead rows."""
    import dataclasses

    import repro_torch.kernels.graph_scan as gs
    from repro_torch import kernels as K
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import scorer as sc
    from repro_torch.index import graph
    from repro_torch.testing import assert_topk_close, dot_tol
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3000, 32, device=cuda, generator=g)
    q = torch.randn(40, 32, device=cuda, generator=g)
    model = gv.fit(q, x, c=6, d=8, kmeans_iters=4, generator=g, device=cuda)
    s = sc.sorted_gleanvec_quantized_scorer(model, x, block=64)
    gathered = dataclasses.replace(
        graph.build(x, r=8, n_iters=2, device=cuda), beam=32, expand=4)
    fused = graph.with_fused_scan(gathered, s)
    nbr = fused.nbr_rows[:40].clone()
    nbr[:, 1] = nbr[:, 0]
    nbr[:, 2] = -1
    rid = s.perm.clone()
    rid[::7] = -1
    qs = s.prepare_queries(q)
    args = (qs.q_scaled, qs.q_lo, s.block_tags, rid, s.codes, nbr,
            torch.full((40, 32), -3.4e38, device=cuda),
            torch.full((40, 32), -1, dtype=torch.int32, device=cuda))
    plain = gs.graph_scan_beam_step_plain(*args, s.layout_block)

    def counters():
        return (K.graph_beam_search.launches,
                K.graph_scan_beam_step.launches)

    before = counters()
    want = gathered.search(q, s, 10)
    assert counters() == before

    def refuse(*a, **k):
        raise AssertionError("plain path taken for a CUDA tensor")

    monkeypatch.setattr(gs, "graph_scan_beam_step_plain", refuse)
    monkeypatch.setattr(gs, "graph_beam_search_plain", refuse)
    hops = graph._beam_qstate(qs, s, fused, 10, 32, 256, expand=4)[2]
    got = fused.search(q, s, 10)
    torch.cuda.synchronize()
    assert int(hops) > 0
    assert counters() == (before[0] + 2, before[1])
    tol = dot_tol(float(qs.q_scaled.norm(dim=-1).max()),
                  float(s.codes.float().norm(dim=1).max()), 8,
                  float(qs.q_lo.abs().max()))
    assert_topk_close(got, want, tol, "fused vs gathered")
    assert_topk_close(K.graph_scan_beam_step(*args,
                                             layout_block=s.layout_block),
                      plain, tol, "graph_scan_beam_step vs plain")
    assert counters() == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_cuda_train_step_runs_on_the_card(cuda):
    """A training step built by ``build_bundle`` (danube's and MIND's smoke
    configs) runs every op on the card: a dispatch mode records the device
    of every tensor an op takes or makes, and none that holds data is on
    the CPU; the metrics stay device scalars (no host sync in the step)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import tree
    from repro_torch.analysis.trace_rules import sync_count
    from repro_torch.configs import registry
    from repro_torch.launch import steps, train

    class _Devices(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.cpu = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree.leaves([args, kwargs or {}, out]):
                # a 0-dim CPU tensor is a wrapped Python number, an empty one
                # the checkpoint's placeholder: neither holds data
                if isinstance(t, torch.Tensor) and t.device.type == "cpu" \
                        and t.ndim > 0 and t.numel() > 0:
                    self.cpu.append(f"{func} {tuple(t.shape)} {t.dtype}")
            return out

    for arch, shape in (("h2o-danube-3-4b", "train_4k"),
                        ("mind", "train_batch")):
        bundle = steps.build_bundle(arch, shape, smoke=True)
        assert bundle.device.type == "cuda"
        params = train.materialize(bundle.args[0], bundle.device)
        opt = bundle.opt_init(params)
        batch = train.make_batch(registry.get(arch), bundle, 0)
        params, opt, _ = bundle.fn(params, opt, batch)   # warm-up
        mode = _Devices()
        with mode:
            params, opt, metrics = bundle.fn(params, opt, batch)
        assert not mode.cpu, (arch, sorted(set(mode.cpu))[:8])
        assert all(t.device.type == "cuda" for t in tree.leaves(
            [params, opt, metrics]))
        n_sync = sync_count(lambda: bundle.fn(params, opt, batch))
        assert n_sync == 0, (arch, n_sync)
        assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.cuda
def test_cuda_gnn_steps_run_on_the_card(cuda):
    """One ``ogb_products``-shaped and one ``minibatch_lg``-shaped GCN step
    at smoke size (graphs drawn on the card) after a warm-up: no host sync,
    every leaf and metric on the card, finite loss; the minibatch's
    sampled ids are those of the CPU path on the same draws."""
    from repro_torch import tree
    from repro_torch.analysis.trace_rules import sync_count
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun, steps, train
    from repro_torch.models import gnn
    module = registry.get("gcn-cora")
    for shape in ("ogb_products", "minibatch_lg"):
        bundle = steps.build_bundle("gcn-cora", shape, smoke=True)
        params = train.materialize(bundle.args[0], bundle.device)
        opt = bundle.opt_init(params)
        graph = train.make_graph(module, bundle, 0)
        batch = train.make_batch(module, bundle, 0, 0, graph)
        params, opt, _ = bundle.fn(params, opt, batch)     # warm-up
        batch = train.make_batch(module, bundle, 1, 0, graph)
        out = {}
        n_sync = sync_count(lambda: out.update(r=bundle.fn(params, opt,
                                                           batch)))
        params, opt, metrics = out["r"]
        assert n_sync == 0, (shape, n_sync)
        assert all(t.device.type == "cuda" for t in tree.leaves(
            [params, opt, metrics]))
        assert bool(torch.isfinite(metrics["loss"]))
    cpu = {k: v.cpu() for k, v in batch.items()}
    got = gnn.sample_neighbors(batch["indptr"], batch["indices"],
                               batch["seeds"], batch["rand1"])
    want = gnn.sample_neighbors(cpu["indptr"], cpu["indices"], cpu["seeds"],
                                cpu["rand1"])
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["search_oi13m", "search_oi13m_sorted"])
def test_cuda_vs_search_launches_b1_without_host_sync(cuda, shape):
    """The paper's search bundle at smoke on the card: one
    ``gleanvec_sq_topk`` launch a step, no host sync (after a warm-up),
    and the CPU bundle's top 10 on the same inputs."""
    from repro_torch import kernels as K
    from repro_torch.analysis.trace_rules import sync_count
    from repro_torch.launch import steps
    from repro_torch.testing import assert_topk_close, dot_tol
    bundle = steps.build_bundle("gleanvec-paper", shape, smoke=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, tags, x_low, x_full, a = bundle.args
    c, d, dim = a.shape
    # full rows: their cluster's view (orthonormal rows) plus N(0, 0.05^2)
    # noise, so the rerank reorders the candidates, while the reduced
    # ranking stays close enough that the card's and the CPU's top kappa
    # hold the same top 10
    a = torch.linalg.qr(torch.randn(c, dim, d, device=cuda,
                                    generator=gen))[0].transpose(1, 2)
    tags = torch.randint(0, c, tags.shape, device=cuda, generator=gen,
                         dtype=torch.int32)
    x_low = torch.randn(x_low.shape, device=cuda, generator=gen)
    rows = tags.long().repeat_interleave(x_low.shape[0] // tags.shape[0])
    noise = torch.randn((x_low.shape[0], dim), device=cuda, generator=gen)
    x_full = torch.bmm(x_low[:, None, :], a[rows])[:, 0] + 0.05 * noise
    args = [torch.randn(q.shape, device=cuda, generator=gen), tags, x_low,
            x_full, a.contiguous()]
    bundle.fn(*args)                                     # warm-up
    before = K.gleanvec_sq_topk.launches
    out = {}
    n_sync = sync_count(lambda: out.update(r=bundle.fn(*args)))
    vals, ids = out["r"]
    assert K.gleanvec_sq_topk.launches == before + 1
    assert n_sync == 0, n_sync
    cpu = steps.build_bundle("gleanvec-paper", shape, smoke=True,
                             device="cpu")
    want = cpu.fn(*[a.cpu() for a in args])
    assert_topk_close((vals.cpu(), ids.cpu()), want,
                      dot_tol(float(args[0].norm(dim=1).max()),
                              float(args[3].norm(dim=1).max()),
                              args[3].shape[1]), shape)


@pytest.mark.cuda
def test_cuda_lm_prefill_launches_kernel_not_plain(cuda, monkeypatch):
    """The LM's prefill on the card runs every layer's attention through
    the ``flash_attention`` kernel (one launch per layer, never the plain
    version), and the kernel agrees with the plain version on one layer's
    inputs; ``generate`` serves from the same path."""
    import importlib

    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import decode
    from repro_torch.testing import attention_abs_mix, attention_error
    fam = importlib.import_module("repro_torch.kernels.flash_attention")
    plain = fam.flash_attention_plain

    def refuse(*a, **k):
        raise AssertionError("plain path taken for a CUDA tensor")

    cfg = registry.get("h2o-danube-3-4b").make_config(smoke=True)
    params = tfm.init(cfg, seed=0, device=cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    monkeypatch.setattr(fam, "flash_attention_plain", refuse)
    before = K.flash_attention.launches
    logits, cache = tfm.prefill_step(params, prompt, cfg)
    tokens = decode.generate(params, prompt, 3, cfg, device=cuda)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 2 * cfg.n_layers
    assert bool(torch.isfinite(logits).all()) and tokens.shape == (2, 43)
    q = torch.randn(2, 40, cfg.n_heads, cfg.d_head, device=cuda,
                    dtype=torch.bfloat16).transpose(1, 2)
    k = torch.randn(2, 40, cfg.n_kv_heads, cfg.d_head, device=cuda,
                    dtype=torch.bfloat16).transpose(1, 2)
    got = K.flash_attention(q, k, k, window=cfg.swa_window)
    monkeypatch.undo()
    want = plain(q, k, k, window=cfg.swa_window)
    assert attention_error(got, want, attention_abs_mix(
        q, k, k, window=cfg.swa_window))[1] <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [12, 10], ids=["group6", "group5"])
def test_cuda_moe_prefill_launches_wgmma_kernel_not_plain(cuda, monkeypatch,
                                                         heads):
    """An MoE model's prefill on the card (grok-1's smoke config widened to
    dh 128 and GQA groups 6 and 5 over 2 KV heads, bf16, as grok-1 and
    maverick run) takes ``flash_wgmma_kernel`` in every layer, never the
    plain version, and ``generate`` serves from the same path."""
    import dataclasses
    import importlib

    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import decode
    fam = importlib.import_module("repro_torch.kernels.flash_attention")

    def refuse(*a, **k):
        raise AssertionError("plain path taken for a CUDA tensor")

    cfg = dataclasses.replace(
        registry.get("grok-1-314b").make_config(smoke=True), n_heads=heads,
        n_kv_heads=2, d_head=128, param_dtype=torch.bfloat16)
    params = tfm.init(cfg, seed=0, device=cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 48), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    picked = []
    orig = attention.flash_attention

    def spy(q, k, v, causal=True, window=None):
        picked.append(fam.VARIANTS[fam._variant(q, k, v)])
        return orig(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(fam, "flash_attention_plain", refuse)
    monkeypatch.setattr(attention, "flash_attention", spy)
    before = K.flash_attention.launches
    logits, _ = tfm.prefill_step(params, prompt, cfg)
    tokens = decode.generate(params, prompt, 3, cfg, device=cuda)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 2 * cfg.n_layers
    assert picked == ["flash_wgmma_kernel"] * (2 * cfg.n_layers)
    assert bool(torch.isfinite(logits).all()) and tokens.shape == (2, 51)


def _plain_tol(q, x, lo=None):
    from repro_torch.testing import dot_tol
    return dot_tol(float(q.reshape(-1, q.shape[-1]).norm(dim=1).max()),
                   float(x.to(torch.float32).norm(dim=1).max()), q.shape[-1],
                   0.0 if lo is None else float(lo.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [129, 200, 1000])
def test_cuda_topk_above_one_pass_matches_plain(cuda, k):
    """k above the 128 entries of one scan pass: every top-k kernel
    against its plain version (ragged M and N, masked rows)."""
    from repro_torch import kernels as K
    from repro_torch.testing import assert_topk_close
    g = torch.Generator(device=cuda).manual_seed(k)
    m, n, c, d, lb = 37, 5003, 9, 48, 64
    q = torch.randn(m, d, device=cuda, generator=g)
    x = torch.randn(n, d, device=cuda, generator=g)
    assert_topk_close(K.ip_topk(q, x, k), K.ip_topk_plain(q, x, k),
                      _plain_tol(q, x), "ip_topk")
    qs = torch.randn(m, c, d, device=cuda, generator=g)
    qlo = torch.randn(m, c, device=cuda, generator=g)
    u8 = torch.randint(0, 256, (n, d), device=cuda, generator=g,
                       dtype=torch.uint8)
    tags = torch.randint(0, c, (n,), device=cuda, generator=g,
                         dtype=torch.int32)
    rid = torch.arange(n, dtype=torch.int32, device=cuda)
    rid[torch.rand(n, device=cuda, generator=g) < 0.1] = -1
    tol = _plain_tol(qs, u8, qlo)
    assert_topk_close(K.gleanvec_sq_topk(qs, qlo, tags, u8, k, row_ids=rid),
                      K.gleanvec_sq_topk_plain(qs, qlo, tags, u8, k,
                                               row_ids=rid), tol, "gathered")
    nb = -(-n // lb)
    btags = torch.randint(0, c, (nb,), device=cuda, generator=g,
                          dtype=torch.int32)
    perm = torch.randperm(n, device=cuda, generator=g).to(torch.int32)
    perm[torch.rand(n, device=cuda, generator=g) < 0.2] = -1
    assert_topk_close(
        K.gleanvec_sq_topk(qs, qlo, btags, u8, k, row_ids=perm,
                           layout_block=lb),
        K.gleanvec_sq_topk_plain(qs, qlo, btags, u8, k, row_ids=perm,
                                 layout_block=lb), tol, "sorted")
    sched = torch.stack([torch.randperm(nb, device=cuda, generator=g)[:12]
                         for _ in range(m)]).to(torch.int32)
    sched[:, 5] = -1
    args = (qs, qlo, btags, perm, u8, sched, k, lb)
    got, want = K.ivf_scan_topk(*args), K.ivf_scan_topk_plain(*args)
    assert_topk_close(got, want, tol, "ivf_scan_topk")
    assert torch.equal(got[1] < 0, want[1] < 0)


@pytest.mark.cuda
def test_cuda_kmeans_assign_many_centers_matches_plain(cuda):
    """C = 100 at D = 512 (one tile of centers) and C = 300 (three tiles):
    the kernel against its plain version, and a tie across the tiles goes
    to the first center."""
    from repro_torch import kernels as K
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3001, 512, device=cuda, generator=g)
    for c in (100, 300):
        cent = torch.randn(c, 512, device=cuda, generator=g)
        tags, sims = K.kmeans_assign(x, cent)
        want_tags, want_sims = K.kmeans_assign_plain(x, cent)
        tol = _plain_tol(x, cent)
        assert float((sims - want_sims).abs().max()) <= tol
        assert float((tags != want_tags).float().mean()) <= 0.001  # near-ties
    cent[250] = cent[3]
    tags, _ = K.kmeans_assign(cent[3].expand(20, 512).contiguous() + 0.0,
                              cent)
    assert bool((tags == 3).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 300, 4097])
def test_cuda_gathered_matches_plain_at_ragged_n(cuda, n, monkeypatch):
    """The gathered GleanVec kernels (bucketing, fused top-k, dense
    scores through a buffer of 64 queries at a time) against their plain
    versions at N off the tile, C = 100 tags with an empty one."""
    import importlib

    from repro_torch import kernels as K
    from repro_torch.testing import assert_topk_close
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.kernels.gleanvec_sq"), "DENSE_BUFFER", 1)
    g = torch.Generator(device=cuda).manual_seed(n)
    m, c, d = 70, 100, 40
    qs = torch.randn(m, c, d, device=cuda, generator=g)
    qlo = torch.randn(m, c, device=cuda, generator=g)
    x = torch.randn(n, d, device=cuda, generator=g)
    u8 = torch.randint(0, 256, (n, d), device=cuda, generator=g,
                       dtype=torch.uint8)
    tags = torch.randint(0, c, (n,), device=cuda, generator=g,
                         dtype=torch.int32)
    tags[tags == 3] = 4
    for got, want in zip(K.bucket_rows_by_tag(tags, c),
                         K.bucket_rows_by_tag_plain(tags, c)):
        assert torch.equal(got, want)
    for codes in (x, u8):
        tol = _plain_tol(qs, codes, qlo)
        assert_topk_close(K.gleanvec_sq_topk(qs, qlo, tags, codes, 10),
                          K.gleanvec_sq_topk_plain(qs, qlo, tags, codes, 10),
                          tol, "gathered top-k")
        dense = K.gleanvec_sq(qs, qlo, tags, codes)
        assert float((dense - K.gleanvec_sq_plain(qs, qlo, tags, codes))
                     .abs().max()) <= tol
    ip = K.gleanvec_ip(qs, tags, x)
    assert float((ip - K.gleanvec_ip_plain(qs, tags, x)).abs().max()) \
        <= _plain_tol(qs, x)


@pytest.mark.cuda
def test_cuda_entry_points_take_100_clusters(cuda):
    """``gleanvec.fit(C=100)`` and ``ivf.build(n_lists=100)`` run on the
    card (k-means assignment over one tile of 100 centers); the gathered and
    sorted GleanVec scans over 100 clusters serve kappa = 200 and agree."""
    from repro_torch import kernels as K
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import scorer as sc
    from repro_torch.index import ivf
    from repro_torch.testing import assert_topk_close
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(20000, 64, device=cuda, generator=g)
    q = torch.randn(300, 64, device=cuda, generator=g)
    before = K.kmeans_assign.launches
    model = gv.fit(q, x, c=100, d=16, kmeans_iters=4, generator=g,
                   device=cuda)
    idx = ivf.build(x, n_lists=100, n_iters=4, generator=g, device=cuda)
    torch.cuda.synchronize()
    assert K.kmeans_assign.launches > before
    assert model.centers.shape == (100, 64) and idx.centers.shape[0] == 100
    gathered = sc.gleanvec_quantized_scorer(model, x)
    srt = sc.sorted_gleanvec_quantized_scorer(model, x, block=64)
    got = K.scorer_topk(gathered, q[:40], 200)
    want = K.scorer_topk(srt, q[:40], 200)
    qs = gathered.prepare_queries(q[:40])
    tol = _plain_tol(qs.q_scaled, gathered.codes, qs.q_lo)
    assert_topk_close(got, want, tol, "gathered vs sorted at C=100")
