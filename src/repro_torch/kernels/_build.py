"""Build and bind the CUDA kernels of ``kernels/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` (which may include
the ``csrc/*.cuh`` headers beside them) for Hopper (``sm_90a``) into an
object file, all sources at once in parallel, and links them into one
shared library with a plain C interface under ``<root>/<hash>/``.  The
root is ``build/repro_torch_kernels/`` at the top of the checkout when
the package lies in one (``src/`` beside a ``pyproject.toml``), else
``$XDG_CACHE_HOME/repro_torch_kernels/`` (``~/.cache`` when the
variable is unset), which serves an installed package: it ships the
sources and headers as package data.  The hash covers the sources, the
headers and the flags, so an edited source or header builds anew and an
unchanged tree is reused.  The library is loaded with ``ctypes``; every
pointer and the stream travel as ``c_void_p``, every int as ``c_int``
and the attention's soft cap as ``c_float``.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
CSRC = KERNELS_DIR / "csrc"
# ``-Xptxas -v`` only reports registers and spills (into BUILD_LOG).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the exported functions (all return a cudaError_t).
SIGNATURES = {
    "repro_gram_f64": (_P, _P, _P, _I, _I, _I, _P),
    "repro_gram_f32": (_P, _P, _P, _I, _I, _I, _P),
    "repro_schwarz_fwd_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "repro_schwarz_fwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "repro_schwarz_bwd_f64": (_P,) * 10 + (_I,) * 4 + (_P,),
    "repro_schwarz_bwd_f32": (_P,) * 10 + (_I,) * 4 + (_P,),
    # ..., causal, window, softcap (a c_float), [part,] stream
    "repro_flash_attention_f32": (_P,) * 5 + (_I,) * 8 + (_F, _P),
    "repro_flash_attention_bf16": (_P,) * 6 + (_I,) * 8 + (_F, _P),
    "repro_flash_attention_bwd_bf16": (_P,) * 10 + (_I,) * 8 + (_F, _P),
    "repro_flash_attention_bwd_f32": (_P,) * 10 + (_I,) * 8 + (_F, _P),
    "repro_flash_attention_bwd_f32_part":
        (_P,) * 10 + (_I,) * 8 + (_F, _I, _P),
    "repro_flash_attention_bwd_bf16_part":
        (_P,) * 10 + (_I,) * 8 + (_F, _I, _P),
    "repro_rglru_scan_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    "repro_rglru_scan_bf16": (_P, _P, _P, _I, _I, _I, _I, _P),
    "repro_rglru_scan_bwd_carry_f32": (_P,) * 3 + (_I, _I, _I, _P),
    "repro_rglru_scan_bwd_carry_bf16": (_P,) * 3 + (_I, _I, _I, _P),
    "repro_rglru_scan_bwd_f32": (_P,) * 6 + (_I, _I, _I, _P),
    "repro_rglru_scan_bwd_bf16": (_P,) * 6 + (_I, _I, _I, _P),
    "repro_ssd_scan_f32": (_P,) * 10 + (_I,) * 6 + (_P,),
    "repro_ssd_scan_bwd_f32": (_P,) * 16 + (_I,) * 7 + (_P,),
}

NUM_SMS = 132      # an H100's SMs, which the launch plans fill
DTYPES = (torch.float64, torch.float32)   # what the DD-KF kernels take
LM_DTYPES = (torch.float32, torch.bfloat16)   # what the LM kernels take

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


def _inputs() -> list:
    """Every file the build reads: the sources and the headers they
    include."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def build_root(kernels_dir: pathlib.Path = KERNELS_DIR) -> pathlib.Path:
    """Where the library is built for a package whose ``kernels``
    directory is ``kernels_dir``: under the checkout's ``build/`` when
    the package lies in one, else under the user's cache directory."""
    root = kernels_dir.parents[2]          # kernels -> repro_torch -> src
    if kernels_dir.parents[1].name == "src" and (
            root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return pathlib.Path(cache) / "repro_torch_kernels"


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in _inputs():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_root() / h.hexdigest()[:16] / "librepro_torch_kernels.so"


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
    """Compile and link the library unless it exists; returns its path.

    Processes that find no library build it one at a time (an advisory
    lock beside it, released when its holder exits): the ranks of a
    distributed run wait for the first and load its library."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            _compile(lib)
    return lib


def _compile(lib: pathlib.Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [pathlib.Path(tmp) / (s.stem + ".o") for s in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                  for s, o in zip(_sources(), objs)])
        part = pathlib.Path(tmp) / lib.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                   "-o", str(part)]])
        # Atomic publish: a concurrent reader either sees no library or
        # a whole one.
        os.replace(part, lib)


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


def check_inputs(name: str, tensors: dict, dtype=None,
                 dtypes: tuple = DTYPES) -> torch.dtype:
    """Validate what a kernel takes: one dtype (one of ``dtypes``), then
    CUDA (or ``meta``: the wrapper's meta route, which allocates the
    launch's tensors on ``meta`` and launches nothing), contiguous, one
    device.  Returns the dtype."""
    first = next(iter(tensors.values()))
    dtype = first.dtype if dtype is None else dtype
    if dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name}: dtype must be {names} (got {dtype})")
    for k, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {k} is {t.dtype}, expected {dtype}")
    for k, t in tensors.items():
        if not (t.is_cuda or t.is_meta):
            raise ValueError(f"{name}: {k} must be a CUDA tensor (got "
                             f"{t.device}); the plain version serves CPU "
                             f"tensors through kernels.ops")
        if t.device != first.device:
            raise ValueError(f"{name}: {k} is on {t.device}, expected "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return dtype


def check_aligned(name: str, tensors: dict) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary, as
    the kernels' 16-byte loads and bulk copies need (a view that starts
    at an odd element of an f64 or f32 storage does not)."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def check_shape(name: str, key: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
