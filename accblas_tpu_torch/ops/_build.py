"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
built at first use into ``build/accblas_tpu_torch/`` at the root of the
checkout. The file name carries a hash of the sources and flags, so an
edited source builds anew and an unchanged one is reused. Nothing here runs
at import time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..accessor import dtypes
from ..utils.spans import span

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "accblas_tpu_torch"

# -fmad=false: no mul+add contraction anywhere, so the error-free transforms
# of df64.cuh hold; two_prod asks for its fused multiply-add explicitly.
# -Xptxas -v: each kernel's registers and spills, kept in the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"  # where the CUDA toolkit puts it
# the build log's last line: nvcc's wall seconds for the library
BUILD_SECONDS = "build seconds:"

_loaded: dict[str, ctypes.CDLL] = {}
# seconds this process has spent in the loads of `load` that did work (a
# library already loaded adds nothing)
load_seconds = 0.0
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}

# run-time codes of the kernels' template parameters (csrc/accessor.cuh)
STORAGE_CODE = {"f32": 0, "bf16": 1, "f16": 2, "f8e4m3": 3, "f8e5m2": 4}
TIER_CODE = {"f32": 0, "bf16": 1, "f16": 2, "df64_fast": 3, "df64_precise": 4}
_DTYPE_CODE = {dtypes.torch_dtype(name): code for name, code in STORAGE_CODE.items()}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(_NVCC_DEFAULT):
        return _NVCC_DEFAULT
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path):
    """Start nvcc on csrc/<name>.cu, writing to a temporary file beside `out`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", tmp, str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _wait(proc, t0: float):
    """nvcc's output and its wall seconds since t0, once it has exited."""
    log, _ = proc.communicate()
    return log, time.perf_counter() - t0


def _finish(name: str, proc, tmp: str, out: Path, log: str, seconds: float, builds: int):
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(
        f"{log}{BUILD_SECONDS} {seconds:.1f} (nvcc wall time, {builds} built at once)\n")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def build(*names: str) -> list[Path]:
    """Build the named sources (all of csrc/*.cu if none), concurrently, where
    no up-to-date library exists yet. Returns the library paths."""
    names = names or tuple(sorted(p.stem for p in _CSRC.glob("*.cu")))
    paths = [_lib_path(n) for n in names]
    jobs = []
    # one waiter a compiler, so that each library's seconds are its own
    pool = ThreadPoolExecutor(len(names) or 1)
    try:
        t0 = time.perf_counter()
        for n, p in zip(names, paths):
            if not p.exists():
                jobs.append((n, *_start(n, p), p))
        waits = [pool.submit(_wait, proc, t0) for _, proc, _, _ in jobs]
        for (name, proc, tmp, out), done in zip(jobs, waits):
            _finish(name, proc, tmp, out, *done.result(), len(jobs))
    finally:
        # on a failure, stop the other compilers and drop their partial output
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
        pool.shutdown()
    return paths


def build_log(name: str) -> str:
    """nvcc's output for the current library of csrc/<name>.cu (ptxas'
    registers and spills per kernel), built first if needed; its last line,
    after BUILD_SECONDS, the seconds nvcc took and how many libraries were
    compiled at once."""
    (path,) = build(name)
    return path.with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed; the
    seconds a load that does work takes (build and dlopen) add to
    `load_seconds`."""
    global load_seconds
    lib = _loaded.get(name)
    if lib is None:
        t0 = time.perf_counter()
        with span("accblas.load"):
            (path,) = build(name)
            lib = _loaded[name] = ctypes.CDLL(str(path))
        load_seconds += time.perf_counter() - t0
    return lib


def function(lib: str, name: str, argtypes):
    """C entry point `name` of csrc/<lib>.cu, with its argument types set;
    cached per (library, entry point), so a call costs a dict lookup.
    Every entry point returns a cudaError_t as an int."""
    fn = _functions.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[(lib, name)] = fn
    return fn


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of CUDA tensor t's device, for a
    launch through ctypes (no Stream object is made)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


# the scratch of the kernels that fold across blocks in one launch (the DOT,
# the window sum): 1024 block partials of 8 bytes, then the ticket counter
# that finds the last block (csrc/reduce.cuh kScratchBytes, which each
# library reports as accblas_scratch_bytes())
SCRATCH_BYTES = 1024 * 8 + 4
_scratch: dict[tuple[int, int], torch.Tensor] = {}


def scratch(t: torch.Tensor, stream: int) -> int:
    """The address of the scratch buffer of stream `stream` of t's device,
    made (zeroed) at its first use. One buffer a (device, stream): the calls
    on a stream use it in stream order, and each call leaves its ticket at
    0 for the next."""
    key = (t.get_device(), stream)
    buf = _scratch.get(key)
    if buf is None:  # zeroed on the current stream, `stream`, before its first call
        buf = _scratch[key] = t.new_zeros(SCRATCH_BYTES, dtype=torch.uint8)
    return buf.data_ptr()


_CURRENT = contextlib.nullcontext()


def on_device(t: torch.Tensor):
    """A context that makes CUDA tensor t's device current for a launch;
    nothing to switch when it already is."""
    idx = t.get_device()
    return _CURRENT if torch.cuda.current_device() == idx else torch.cuda.device(idx)


def tier(ar: str, precise: bool, op: str) -> str:
    """The kernel tier of an arithmetic type: df64 splits into its fast and
    precise forms; f64 has no tier."""
    if ar == "df64":
        return "df64_precise" if precise else "df64_fast"
    if ar not in TIER_CODE:
        raise ValueError(f"{op} has no {ar} arithmetic tier (f32, bf16, f16, df64)")
    return ar


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def storage_code(t, what: str) -> int:
    """The kernel storage code of tensor `t`'s dtype; raises on a dtype the
    kernels do not take."""
    code = _DTYPE_CODE.get(t.dtype)
    if code is None:
        raise ValueError(f"{what}: dtype {t.dtype} is not a kernel storage type "
                         f"({', '.join(STORAGE_CODE)})")
    return code
