"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Each of ``src/repro_torch/csrc/*.cu`` compiles in its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects into
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds), placed in ``build/repro_torch/`` at the repository
root.
The kernels therefore build only from a source checkout (``src/`` layout):
an installed copy of the package carries no ``csrc/`` and :func:`build`
says so. The file name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Nothing is built when
a module is imported: only :func:`library` builds, and only the CUDA path
of a kernel wrapper calls it.

Every pointer and the stream pass as ``c_void_p`` (a bare Python int would
be cut to 32 bits), and every C entry returns ``cudaGetLastError()`` right
after its launch: a launch the runtime refuses never runs, and
``torch.cuda.synchronize()`` would not report it. :func:`check` raises on
a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_log = ""      # nvcc/ptxas report of the build this process ran
build_seconds: dict = {}   # source name -> seconds its nvcc ran, that build


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "cannot be built")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless this exact build exists; returns the .so.
    Records each source's compile seconds in :data:`build_seconds`."""
    global build_log
    if not sources():
        raise RuntimeError(
            f"no CUDA sources under {CSRC}: the port's kernels build only "
            f"from a source checkout (run with PYTHONPATH=src)")
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{tag}.tmp.so")
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    logs = [obj.with_suffix(".log") for obj in objs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    procs, done = [], {}
    try:
        t0 = time.perf_counter()
        for cmd, log in zip(cmds, logs):        # every source at once
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(cmd, stdout=fh,
                                              stderr=subprocess.STDOUT))
        while len(done) < len(procs):
            for i, proc in enumerate(procs):
                if i not in done and proc.poll() is not None:
                    done[i] = time.perf_counter() - t0
            time.sleep(0.05)
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}"
                                   f":\n{' '.join(cmd)}\n{log.read_text()}")
        text = [log.read_text() for log in logs]
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code "
                               f"{proc.returncode}:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
    finally:
        for p in procs:                 # stop the rest after a failure
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in objs + logs:
            f.unlink(missing_ok=True)
    os.replace(tmp, out)
    build_log = "".join(text)
    build_seconds.clear()
    build_seconds.update((src.name, done[i])
                         for i, src in enumerate(sources()))
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.repro_swap_linear_q.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                        i, i, i, i, i, i, p]
    lib.repro_swap_linear_q.restype = i
    lib.repro_dequant.argtypes = [p, p, p, i64, i64, i, i, p]
    lib.repro_dequant.restype = i
    lib.repro_paged_attention.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                          i, i, i, f, i, f, i, p]
    lib.repro_paged_attention.restype = i
    lib.repro_paged_split_plan.argtypes = [p, i, i, i, i, p, p]
    lib.repro_paged_split_plan.restype = i
    lib.repro_wkv6.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.repro_wkv6.restype = i
    lib.repro_swap_linear.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                      i, i, i, i, p]
    lib.repro_swap_linear.restype = i
    lib.repro_flash_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f,
                                          i, i, i, f, i, i, p]
    lib.repro_flash_attention.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


class LaunchCounter:
    """Launches of one kernel: ``count`` in all, ``by_shape`` per launch
    key. A wrapper bumps it where it launches its kernel, and nowhere
    else, so a run can show that its path went through the kernel."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.by_shape: dict = {}

    def bump(self, key) -> None:
        with self._lock:
            self.count += 1
            self.by_shape[key] = self.by_shape.get(key, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_shape = {}


def needs_grad(*tensors) -> bool:
    """True when autograd records this call: grad mode is on and one of
    ``tensors`` (None skipped) requires grad. Only then does a wrapper with
    an ``autograd.Function`` route through it, so inference runs exactly
    as it did without one."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel without a backward would be recorded by
    autograd: its CUDA output carries no ``grad_fn``, so a gradient would
    vanish without a word. The CPU path needs no guard: it runs the plain
    version, which autograd differentiates."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad under grad mode; run it under torch.no_grad() "
            f"or on the CPU")


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
