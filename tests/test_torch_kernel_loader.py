"""The kernel loader and launch counters under concurrent serving threads
(``repro_torch.kernels.load_library`` / ``count_launch``): a dispatcher
and a refresh worker may ask for the same library, and launch the same
kernels, at once.

With ``build`` and the library load stubbed (no ``nvcc`` here), many
threads asking for one library at once build it once, load it once and
bind each binder once (more threads than cores, a short switch
interval).
"""
import os
import sys
import threading
import time
import types

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

