"""Build and bind the CUDA kernels of ``kernels/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper
(``sm_90a``) into an object file, all sources at once in parallel, and
links them into one shared library with a plain C interface under
``build/repro_torch_kernels/<hash>/`` at the root of the checkout.  The
hash covers the sources and the flags, so an edited source builds anew
and an unchanged one is reused.  The library is loaded with ``ctypes``;
every pointer and the stream travel as ``c_void_p`` and every int as
``c_int``.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
# ``-Xptxas -v`` only reports registers and spills (into BUILD_LOG).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the exported functions (all return a cudaError_t).
SIGNATURES = {
    "repro_gram_f64": (_P, _P, _P, _I, _I, _I, _P),
    "repro_gram_f32": (_P, _P, _P, _I, _I, _I, _P),
    "repro_schwarz_fwd_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "repro_schwarz_fwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "repro_schwarz_bwd_f64": (_P,) * 10 + (_I, _I, _I, _P),
    "repro_schwarz_bwd_f32": (_P,) * 10 + (_I, _I, _I, _P),
    "repro_schwarz_bwd_splits": (),
}

DTYPES = (torch.float64, torch.float32)   # what the kernels take

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
BUILD_LOG: list = []   # nvcc output of the build this process ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "librepro_torch_kernels.so"


def _run_all(cmds: list) -> None:
    """Run the commands concurrently; raise with the output of any that
    failed, after all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    BUILD_LOG.extend(o for o in outs if o)
    bad = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"$ {' '.join(c)}\n{o}" for c, o in bad))


def build() -> pathlib.Path:
    """Compile and link the library unless it exists; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [pathlib.Path(tmp) / (s.stem + ".o") for s in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                  for s, o in zip(_sources(), objs)])
        part = pathlib.Path(tmp) / lib.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                   "-o", str(part)]])
        # Atomic publish: a concurrent builder either sees no library or
        # a whole one.
        os.replace(part, lib)
    return lib


def load() -> ctypes.CDLL:
    """The bound library, built on first use (thread safe)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(err: int, name: str) -> None:
    """Raise if a C launcher returned a nonzero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


def check_inputs(name: str, tensors: dict, dtype=None) -> torch.dtype:
    """Validate what a kernel takes: CUDA, one dtype (f64 or f32),
    contiguous, one device.  Returns the dtype."""
    first = next(iter(tensors.values()))
    dtype = first.dtype if dtype is None else dtype
    if dtype not in DTYPES:
        raise TypeError(f"{name}: dtype must be float64 or float32 "
                        f"(got {dtype})")
    for k, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {k} must be a CUDA tensor (got "
                             f"{t.device}); the plain version serves CPU "
                             f"tensors through kernels.ops")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {k} is {t.dtype}, expected {dtype}")
        if t.device != first.device:
            raise ValueError(f"{name}: {k} is on {t.device}, expected "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return dtype


def check_shape(name: str, key: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
