"""The kernel loader and launch counters under concurrent serving threads
(``repro_torch.kernels.load_library`` / ``count_launch``): a dispatcher
and a refresh worker may ask for the same library, and launch the same
kernels, at once.

With ``build`` and the library load stubbed (no ``nvcc`` here), many
threads asking for one library at once build it once, load it once and
bind each binder once (more threads than cores, a short switch
interval).

On the card, two threads on two CUDA streams launch one kernel at once at
two batch sizes whose top-k merges take different dynamic shared memory;
every launch must succeed and return what the call returns alone.
"""
import os
import sys
import threading
import time
import types

import pytest
import torch

from repro_torch import kernels as K


def _many(target, n):
    threads = [threading.Thread(target=target) for _ in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_load_builds_once(monkeypatch, tmp_path):
    path = tmp_path / "fake.so"
    builds, loads, binds, got = [], [], [], []

    def build(names):
        builds.append(tuple(names))
        time.sleep(0.05)                # widen the window a race needs
        path.write_bytes(b"")
        return {n: 0.05 for n in names}

    def cdll(p):
        loads.append(p)
        return types.SimpleNamespace(
            cuda_error_string=types.SimpleNamespace())

    monkeypatch.setattr(K, "_LIBS", {})
    monkeypatch.setattr(K, "build", build)
    monkeypatch.setattr(K, "library_path", lambda name: path)
    monkeypatch.setattr(K.ctypes, "CDLL", cdll)

    def bind(lib):
        binds.append(lib)

    _many(lambda: got.append(K.load_library("ip_topk", bind)),
          (os.cpu_count() or 4) * 2)
    assert builds == [("ip_topk",)] and len(loads) == 1 and len(binds) == 1
    assert len(got) == (os.cpu_count() or 4) * 2
    assert all(lib is got[0] for lib in got)



MERGE_SMEM_DEFAULT = 48 * 1024      # a launch past it needs the kernel's cap


def _merge_smem(plan, k):
    """Dynamic shared memory of the top-k merge of a scan plan
    (``topk_common.cuh``: next_pow2(S k) (value, id) pairs)."""
    p = 1
    while p < plan.splits * K.pass_k(k):
        p *= 2
    return p * 8


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ip_topk", "gleanvec_sq_topk"])
def test_cuda_two_threads_launch_one_kernel_at_two_sizes(kernel):
    """A dispatcher's batch of 8 queries and a loop of 1024-query batches,
    each thread on its own stream, launch one kernel at once 2000 times:
    8 queries split the rows 81 ways (a 64 KiB merge, past the default
    48 KiB), 1024 queries 8 ways (8 KiB). Every launch must succeed and
    return the ids of the same call alone. A cap written before every
    launch at that launch's size fails here: the other thread's write can
    land between a thread's write and its launch ("too many resources
    requested for launch")."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from repro_torch.kernels.gleanvec_sq import _bind, sorted_scan_plan
    from repro_torch.kernels.ip_topk import scan_plan
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, d, c, block, k, rounds = 65536, 32, 4, 256, 100, 2000
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if kernel == "ip_topk":
        x = torch.randn(n, d, device=dev, generator=gen)
        qs = {m: torch.randn(m, d, device=dev, generator=gen)
              for m in (8, 1024)}
        calls = {m: (lambda q=q: K.ip_topk(q, x, k)) for m, q in qs.items()}
        plans = {m: scan_plan(m, n, k, sms) for m in qs}
    else:
        codes = torch.randint(0, 256, (n, d), dtype=torch.uint8, device=dev,
                              generator=gen)
        tags = (torch.arange(n // block, device=dev) % c).to(torch.int32)
        calls, plans = {}, {}
        lib = K.load_library("gleanvec_sq", _bind)
        views = lib.gleanvec_sq_sorted_views(block, k, 1)
        for m in (8, 1024):
            q = torch.randn(m, c, d, device=dev, generator=gen)
            lo = torch.randn(m, c, device=dev, generator=gen)
            calls[m] = (lambda q=q, lo=lo: K.gleanvec_sq_topk(
                q, lo, tags, codes, k, layout_block=block))
            plans[m] = sorted_scan_plan(m, n, k, block, views, sms)
    small, big = _merge_smem(plans[8], k), _merge_smem(plans[1024], k)
    assert small > MERGE_SMEM_DEFAULT >= big, (small, big)
    want = {m: call()[1] for m, call in calls.items()}
    torch.cuda.synchronize()
    errors, wrong = [], {}
    start = threading.Barrier(2)

    def serve(m):
        stream = torch.cuda.Stream(dev)
        try:
            with torch.cuda.stream(stream):
                bad = torch.zeros((), dtype=torch.int64, device=dev)
                start.wait()
                for _ in range(rounds):
                    bad += (calls[m]()[1] != want[m]).sum()
                stream.synchronize()
                wrong[m] = int(bad)
        except Exception as e:          # noqa: BLE001 -- reported below
            errors.append(f"{m} queries: {e}")

    threads = [threading.Thread(target=serve, args=(m,)) for m in calls]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert wrong == {8: 0, 1024: 0}, wrong
