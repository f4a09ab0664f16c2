"""Build and load the CUDA kernels of ``tpu_kquant_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled on first use by its own ``nvcc`` process
(all sources at once, in parallel) into a shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o .cache/tkq_torch_build/<name>-<hash>.so <name>.cu

and loaded with ``ctypes``. The file name carries a hash of the sources, so
an edited kernel is rebuilt and a stale library is never loaded. Nothing is
built when the package is imported; only a kernel's first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import resource
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".cache" / "tkq_torch_build"
SOURCES = ("qmm", "qmm_q56", "qmm_q23", "attn_in", "ffn", "prefill", "qmm_int8", "decode_attn",
           "kv_append", "attn_out", "layer", "rot", "kernel_lab", "prefill_lab", "quantize")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# flags of one source on top of NVCC_FLAGS: the quantizers round every
# multiply and add on its own, as the NumPy code they reproduce does
EXTRA_FLAGS = {"quantize": ["-fmad=false"]}


class LaunchCounter:
    """Counts of one kernel's wrapper calls: ``launches`` where it launched
    the CUDA kernel, ``plain_calls`` where it ran the plain PyTorch version
    (CPU tensors). Besides the wrappers, only a CUDA graph touches them
    (runtime.graphs): its capture takes back the calls it recorded
    (``take_back``) and each replay adds them (``add_launches``)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0
        COUNTERS[name] = self

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


COUNTERS: dict[str, LaunchCounter] = {}


def launch_counts() -> dict[str, int]:
    """Every counter's ``launches`` as they stand."""
    return {k: c.launches for k, c in COUNTERS.items()}


def take_back(before: dict[str, int]) -> dict[str, int]:
    """Set every counter's ``launches`` back to ``before`` (a counter made
    since: to 0) and return what was added since, where nonzero: the
    wrapper calls of a CUDA-graph capture, which launch nothing."""
    delta = {}
    for k, c in COUNTERS.items():
        if c.launches != before.get(k, 0):
            delta[k] = c.launches - before.get(k, 0)
        c.launches = before.get(k, 0)
    return delta


def add_launches(delta: dict[str, int]) -> None:
    """Add a captured graph's launches (``take_back``'s delta) at a replay."""
    for k, d in delta.items():
        COUNTERS[k].launches += d

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_declared: set[tuple[str, str]] = set()  # (library, entry point) with argtypes set
_addresses: dict[tuple[str, str], ctypes.c_void_p] = {}  # (library, entry point) -> address


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, under $CUDA_HOME, or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, [])).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every missing library, one nvcc per source, all in parallel.
    Returns the wall seconds spent (0 when everything was built already);
    ``BUILD_TIMES[name]`` holds each library's (wall s when its nvcc was
    reaped, in SOURCES order; CPU s of that nvcc and the compilers it ran)
    of the last build."""
    todo = [(n, _lib_path(n)) for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        before = _children_cpu()
        log, _ = proc.communicate()
        # the reaped nvcc's CPU time, with that of the cicc / ptxas it waited for
        BUILD_TIMES[name] = (time.perf_counter() - t0, _children_cpu() - before)
        if proc.returncode != 0:
            errors.append(f"--- nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


BUILD_TIMES: dict[str, tuple[float, float]] = {}


def _children_cpu() -> float:
    u = resource.getrusage(resource.RUSAGE_CHILDREN)
    return u.ru_utime + u.ru_stime


def _library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (all sources are built first
    if needed); the caller holds ``_lock``."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.tkq_error_string.argtypes = [ctypes.c_int]
        lib.tkq_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def address(name: str, fn: str) -> ctypes.c_void_p:
    """The address of C entry point ``fn`` of library ``name``, for a kernel
    library that calls another's entry point (layer.cu and rot.cu call
    attn_in.cu's and ffn.cu's: csrc/entries.cuh)."""
    with _lock:
        if (name, fn) not in _addresses:
            _addresses[name, fn] = ctypes.c_void_p(
                ctypes.cast(getattr(_library(name), fn), ctypes.c_void_p).value)
        return _addresses[name, fn]


def load(name: str, fn: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (all sources are built first
    if needed), with entry point ``fn`` declared to take ``argtypes`` and
    return an int error code."""
    with _lock:
        lib = _library(name)
        if (name, fn) not in _declared:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            _declared.add((name, fn))
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.tkq_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg}) at launch")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address for a ctypes call."""
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(cond: bool, what: str) -> None:
    """Raise ValueError unless a kernel's input condition holds."""
    if not cond:
        raise ValueError(what)
