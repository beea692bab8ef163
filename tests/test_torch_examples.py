"""The four examples on the port (``examples/torch_*.py``) on the CPU.

quickstart (at QUICKSTART's database size, the reference example's
``make_dataset`` given the same n and D) and streaming_updates (at its
defaults: the reference's loop fixes n) print recall@10 values that are
held against the reference example's (run in processes of their own with
one XLA thread) within RECALL_TOL: the same data and the same
algorithms; the port draws its own k-means++ start, so a query's tenth
neighbour may differ (at QUICKSTART's size the reference reads 1.000
and the port 0.998 to 1.000). serve_vector_search and
train_recsys_retrieval run at small sizes: their recall and agreement must
clear floors below the values they read (1.000 and ~0.9-0.98).
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RECALL_TOL = 0.01
RECALL = re.compile(r"recall@10[^0-9]*([0-9]\.[0-9]+)")
QUICKSTART = {"n": 8000, "dim": 256}
# the reference's quickstart with its database cut to QUICKSTART's size
_REFERENCE_QUICKSTART = f"""
import runpy
from repro.data import vectors
make = vectors.make_dataset
vectors.make_dataset = lambda name, n, d, **kw: make(
    name, n={QUICKSTART['n']}, d={QUICKSTART['dim']}, **kw)
runpy.run_path({str(ROOT / "examples" / "quickstart.py")!r},
               run_name="__main__")
"""


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's quickstart and streaming_updates, started together;
    ``get(name)`` waits for one and returns its output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    cmds = {"quickstart": ["-c", _REFERENCE_QUICKSTART],
            "streaming_updates": [str(ROOT / "examples"
                                      / "streaming_updates.py")]}
    procs = {name: subprocess.Popen(
        [sys.executable, *cmd], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for name, cmd in cmds.items()}

    def get(name):
        out, err = procs[name].communicate(timeout=300)
        assert procs[name].returncode == 0, err[-3000:]
        return out

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("name,args", [
    ("quickstart", ["--n", str(QUICKSTART["n"]),
                    "--dim", str(QUICKSTART["dim"])]),
    ("streaming_updates", [])])
def test_recall_matches_the_reference_example(name, args, reference_runs,
                                              capsys):
    _load(f"torch_{name}").main(["--device", "cpu", *args])
    got = [float(x) for x in RECALL.findall(capsys.readouterr().out)]
    want = [float(x) for x in RECALL.findall(reference_runs(name))]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert abs(g - w) <= RECALL_TOL, (got, want)


def test_serve_example_serves_and_swaps(capsys):
    _load("torch_serve_vector_search").main(
        ["--device", "cpu", "--n", "4000", "--dim", "64", "--d", "16",
         "--clusters", "8", "--queries", "128", "--batch", "64"])
    out = capsys.readouterr().out
    assert float(RECALL.search(out).group(1)) >= 0.95
    assert "queries=128 batches=2" in out
    assert "hot-swapped refit model: version=1" in out


def test_recsys_example_trains_then_retrieves(capsys):
    _load("torch_train_recsys_retrieval").main(
        ["--device", "cpu", "--steps", "12", "--items", "2000",
         "--batch", "64"])
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss ([0-9.]+)", out)]
    assert len(losses) == 2 and all(x == x and x > 0 for x in losses)
    agree = float(re.search(r"full-precision retrieval: ([0-9.]+)",
                            out).group(1))
    assert agree >= 0.8
