"""Builds the port's CUDA kernels and counts their launches.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, which ``ctypes`` loads.
A library is built on first use into ``build/kernels/`` at the repository
root, named by a hash of its sources and flags, so a changed source is
rebuilt and an unchanged one is reused.  ``build_all`` starts one ``nvcc``
per source, all at once, and waits for them together.

``LAUNCHES[name]`` counts the successful launches of each kernel; every
wrapper adds one where it launches, and nowhere else.  ``scratch`` keeps
the buffers of the kernels that merge across blocks: the counters the
arriving blocks count in (the last block resets its counter) and the
fp32 workspace of the partial results.

The threaded controller calls the kernels from several host threads at
once, so the launch counts and the builds are taken under locks: a
concurrent cold start runs one ``nvcc`` per source, and no count is lost.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# no --use_fast_math: the sampler's noise must be the accurate logf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: "collections.Counter[str]" = collections.Counter()
BUILD_SECONDS: dict = {}
BUILD_LOG: dict = {}
_LIBS: dict = {}
_FUNCS: dict = {}
_SCRATCH: dict = {}
_SMS: dict = {}
# re-entrant: library() builds through build_all() under the same lock
_BUILD_LOCK = threading.RLock()
_LAUNCH_LOCK = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}: the CUDA kernels "
                           "build only where the CUDA toolkit is installed")
    return str(path)


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _out(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all(names) -> None:
    """Build every named library that is not built yet, with one ``nvcc``
    process per source running at the same time; raise if any fails.
    Builds take turns: a second caller waits, then finds them built."""
    with _BUILD_LOCK:
        _build_all(names)


def _build_all(names) -> None:
    started = []
    for name in names:
        out = _out(name)
        if name in _LIBS or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in started:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
            continue
        os.replace(tmp, out)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = err
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _BUILD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build_all([name])
                lib = _LIBS[name] = ctypes.CDLL(str(_out(name)))
    return lib


def c_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` from ``csrc/<name>.cu`` with its argument types set; it
    returns the ``cudaError_t`` of its launch.  Configured once, then
    served from a cache keyed by (library, symbol)."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        with _BUILD_LOCK:
            fn = getattr(library(name), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[name, symbol] = fn
    return fn


def scratch(key: str, device, n: int, dtype):
    """A CUDA tensor of at least ``n`` elements of ``dtype``, kept under
    ``key`` on ``device`` across calls: zeroed when made, then as the
    last call left it.  The merge counters of the split kernels live
    here (each kernel leaves its counters at zero again), and their fp32
    workspaces.  The port launches every kernel on the device's default
    stream, from whichever host thread: kernels on one stream run one
    after another, so they take turns with one buffer.  An executor on
    a stream of its own would need a buffer for each stream, and event
    waits on the tensors it hands across."""
    import torch
    buf = _SCRATCH.get((key, device))
    if buf is None or buf.numel() < n or buf.dtype != dtype:
        buf = torch.zeros(max(n, 1024), dtype=dtype, device=device)
        _SCRATCH[key, device] = buf
    return buf


def sm_count(device) -> int:
    """The number of SMs of a CUDA device, read once a device."""
    if device not in _SMS:
        import torch
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def check(name: str, err: int) -> None:
    """Raise on a refused launch, else count it."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES.clear()
