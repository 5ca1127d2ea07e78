"""The kernel build layer under threads, on the CPU: concurrent launch
counts are exact, and concurrent cold loads of one library start one
build.  (The threaded controller calls the kernels from several host
threads at once.)"""
import collections
import sys
import threading
import time

import pytest

from repro_torch.kernels import build


def _together(n, fn):
    """Run ``fn`` on ``n`` threads released at once, switching threads as
    often as the interpreter allows; re-raise any error."""
    gate = threading.Barrier(n)
    errors = []

    def body():
        try:
            gate.wait()
            fn()
        except BaseException as e:      # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=body) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


class _SlowCounter(collections.Counter):
    """A Counter that yields to other threads between the read and the
    write of ``LAUNCHES[name] += 1``, so an unlocked count loses some."""

    def __setitem__(self, key, value):
        time.sleep(1e-5)
        super().__setitem__(key, value)


def test_concurrent_checks_count_exactly(monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", _SlowCounter())
    n, per = 8, 200

    def launches():
        for _ in range(per):
            build.check("fused_sample", 0)
    _together(n, launches)
    assert build.LAUNCHES["fused_sample"] == n * per
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        build.check("fused_sample", 2)
    assert build.LAUNCHES["fused_sample"] == n * per
    build.reset_launches()
    assert build.LAUNCHES == {}


def test_concurrent_cold_loads_build_once(monkeypatch):
    calls = []
    loaded = []

    def fake_build_all(names):
        calls.append(list(names))
        threading.Event().wait(0.05)     # a build takes a while

    def fake_cdll(path):
        loaded.append(path)
        return object()
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    got = []
    _together(8, lambda: got.append(build.library("fused_sample")))
    assert calls == [["fused_sample"]] and len(loaded) == 1
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert build.library("fused_sample") is got[0]
    assert calls == [["fused_sample"]]
