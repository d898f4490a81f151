"""Build the port's native code at first use and load it with ctypes.

Two kinds of shared library, both with a plain C interface:

- the CUDA kernels, ``csrc/*.cu``, compiled by ``nvcc`` for ``sm_90a``
  (route (b) of building a kernel by hand: no PyTorch headers, so a
  build takes seconds, not minutes);
- the host C++ runtime, ``native/core.cpp``, compiled by ``g++``.

Every library lands in ``build/snappy_tpu_torch/`` at the repository
root (listed in ``.gitignore``), named by a hash of its source and
flags, so an edited source rebuilds and a stale library is never loaded.
The first kernel a process needs builds all of ``csrc/*.cu`` at once, one
``nvcc`` per source, all started together. A failed build raises, with
the compiler's output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "snappy_tpu_torch"
CSRC = _PKG / "csrc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-fno-exceptions", "-march=native"]

_lock = threading.Lock()
_kernel_libs: dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


def _target(src: Path, cmd: list[str]) -> Path:
    key = hashlib.sha256(src.read_bytes() + repr(cmd).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{key}.so"


def compile_all(jobs: list[tuple[Path, list[str]]]) -> list[Path]:
    """Compile each ``(source, compiler command)`` into ``BUILD_DIR``.

    Missing libraries build concurrently, under a file lock so that
    parallel test workers build each one once. The compiler's output
    is kept beside each library as ``.log`` (``nvcc -Xptxas -v`` reports
    registers, shared memory and spills there). Returns the paths.
    """
    targets = [_target(src, cmd) for src, cmd in jobs]
    if all(t.exists() for t in targets):
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        running = []
        for (src, cmd), out in zip(jobs, targets):
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log = out.with_suffix(".log")
            with open(log, "w") as f:
                proc = subprocess.Popen(
                    [*cmd, "-o", str(tmp), str(src)],
                    stdout=f, stderr=subprocess.STDOUT,
                )
            running.append((proc, tmp, out, log))
        failed = []
        for proc, tmp, out, log in running:
            if proc.wait() != 0:
                failed.append(f"{' '.join(proc.args)}\n{log.read_text()}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("build failed:\n" + "\n".join(failed))
    return targets


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot build")


def kernel_sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; the first call builds all."""
    with _lock:
        if not _kernel_libs:
            srcs = kernel_sources()
            nvcc = [_nvcc(), *NVCC_FLAGS]
            paths = compile_all([(s, nvcc) for s in srcs])
            for s, p in zip(srcs, paths):
                _kernel_libs[s.stem] = ctypes.CDLL(str(p))
        return _kernel_libs[name]


def host_lib(src: Path) -> ctypes.CDLL:
    """Build (once) and load a host C++ source with ``g++``."""
    (path,) = compile_all([(src, ["g++", *GXX_FLAGS])])
    return ctypes.CDLL(str(path))


def count(counts, key, n=1) -> None:
    """``counts[key] += n`` under one lock for the process.

    The kernel wrappers' launch counts (a module's ``globals()``, a dict or
    a list) are bumped from every shard's thread of a sharded entry at
    once; a bare ``+=`` reads and writes in two steps and can lose an
    increment between them."""
    with _count_lock:
        counts[key] += n


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")


_states: dict = {}
_state_lock = threading.Lock()


def not_capturing(device, name: str) -> None:
    """Raise if card ``device``'s current stream is capturing a CUDA graph:
    ``name``'s scratch cannot be made there, since the capture records its
    allocation and filling instead of running them."""
    with torch.cuda.device(device):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{name}: the first launch on a card and stream is inside a CUDA graph "
                "capture; launch once on that stream before capturing")


def stream_state(device, name: str, make):
    """``make()``, made once for launches of ``name`` on card ``device``'s
    current stream (the stream :func:`launch` passes): scratch that a kernel
    leaves as it found it, one a stream, so that launches on two streams of
    a card never share it. Not made inside a CUDA graph capture
    (:func:`not_capturing`)."""
    key = (name, device.index, torch.cuda.current_stream(device).cuda_stream)
    with _state_lock:
        if key not in _states:
            not_capturing(device, name)
            _states[key] = make()
        return _states[key]


def launch(device, what: str, entry, *args) -> None:
    """Call the C entry ``entry(*args, stream)`` on card ``device``, with that
    card's current stream last, and raise on a non-zero status.

    A C entry launches on the current card and keys its per-card caches by
    it, so the call runs with ``device`` made current: without that, a
    tensor on another card than the current one would be launched to a
    stream of the wrong card."""
    with torch.cuda.device(device):
        check(entry(*args, torch.cuda.current_stream(device).cuda_stream), what)
