"""Build the CUDA sources in `csrc/` with `nvcc` and load them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (`nvcc -gencode arch=compute_90a,code=sm_90a -shared`), named by
a digest of its text, the shared headers' and the flags, so an edited
source or header rebuilds.  The libraries go to `build/torch_kernels/` at
the root of the checkout, which `.gitignore` lists.  Nothing builds at import: `load` builds on first use,
and `build` compiles several sources at once, one `nvcc` process each,
all started together.  Each library's C signatures are declared once,
when `load` first opens it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("round_grad", "encode", "ssd", "flash_attn")

# {C function: (argtypes, restype)}, as `load` takes it
Signatures = dict[str, tuple[list, type]]
# `kernel_error_string` of `csrc/kernel_api.cuh`, in every library
_COMMON: Signatures = {"kernel_error_string": ([ctypes.c_int],
                                               ctypes.c_char_p)}

# Loaded libraries by source name: a shared library is process-wide state
# whatever holds it, so the loader keeps one handle per library.
_LOADED: dict[str, ctypes.CDLL] = {}


class BuildFailure(RuntimeError):
    """A kernel source failed to compile (or no `nvcc` was found)."""


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise BuildFailure("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where source `csrc/<name>.cu` builds to (digest of its text, the
    shared headers' and the flags)."""
    text = b"".join(p.read_bytes() for p in
                    [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def start_nvcc(source: Path, target: Path) -> subprocess.Popen:
    """Start one `nvcc` of `source` into the shared library `target`, with
    the flags of every kernel library and `csrc/` on the include path;
    the caller waits on the process (its output is the `-Xptxas=-v`
    report, or the compiler's errors)."""
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(target),
           str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names: Sequence[str] = SOURCES) -> dict[str, dict]:
    """Compile every named source not yet built, all in parallel.

    Returns `{name: {"seconds": wall time of that nvcc, "log": its
    -Xptxas=-v report}}` (seconds 0.0 and an empty log for a library that
    was already built).  Raises `BuildFailure` with the compiler's output
    when any source fails.
    """
    out = {name: {"seconds": 0.0, "log": ""} for name in names
           if library_path(name).exists()}
    todo = [name for name in names if name not in out]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        target = library_path(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (start_nvcc(CSRC / f"{name}.cu", tmp), tmp, target,
                       time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                            f"{log}")
            continue
        os.replace(tmp, target)
        out[name] = {"seconds": seconds, "log": log}
    if failures:
        raise BuildFailure("kernel build failed:\n" + "\n".join(failures))
    return out


def load(name: str, signatures: Signatures) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed.

    The first call opens it and declares the C `signatures` of its entry
    points (and the shared `kernel_error_string`); later calls return the
    same handle."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn_name, (argtypes, restype) in {**_COMMON, **signatures}.items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, restype
        _LOADED[name] = lib
    return lib


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        msg = lib.kernel_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} "
                           f"({msg})")
