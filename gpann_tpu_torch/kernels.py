"""Build and bind the hand-written CUDA kernels of ``csrc/``.

At first use :func:`library` compiles every ``csrc/*.cu`` with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and loads it
with ``ctypes``. The library lives in ``gpann_tpu_torch/_build/`` (ignored by
git) under a name that carries the hash of the sources and flags, so an edit
to a source rebuilds it. Nothing is built when this module is imported.

``LAUNCHES`` counts the launches of each kernel entry point: one per call
that reaches the kernel, none for the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl"]

# launches per entry point (see module docstring)
LAUNCHES = {"binmin_scan": 0, "bintop2_blocks": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}; set CUDA_HOME")
    return nvcc


def build() -> tuple[str, float, str]:
    """Compile ``csrc/*.cu`` unless the hashed library exists.

    Returns (library path, build seconds (0.0 when cached), ptxas report).
    """
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + headers:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"libgpann_kernels_{h.hexdigest()[:16]}.so")
    log_path = lib + ".log"
    if os.path.exists(lib):
        with open(log_path) as f:
            return lib, 0.0, f.read()
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    with open(log_path, "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, lib)
    return lib, seconds, proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bintop2_blocks.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                   ctypes.c_longlong, i, p]
    lib.bintop2_blocks.restype = i
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bintop2(queries: torch.Tensor, base: torch.Tensor, row_off: torch.Tensor,
            sizes: torch.Tensor, qb: int, cap: int, metric: str,
            entry: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the bin-top-2 kernel; returns (mins f32, argmins int32), both
    [nb*qb, 2*cap/128] as ``[min1 | min2]`` halves.

    ``entry`` names the wrapper whose launch count this call adds to.

    The kernel reads ``base`` in place when its rows are 16-byte aligned
    (``d % 4 == 0``, as at every shape the serving and build paths use). For
    another ``d`` this call copies the queries and the whole base into
    zero-padded columns first: one more read and write of the base and a
    transient second copy in device memory, on every call. A caller that
    scans a large resident base at such a ``d`` should pad it once itself.
    """
    _check(queries, "queries", torch.float32, 2)
    _check(base, "base", torch.float32, 2)
    _check(row_off, "row_off", torch.int64, 1)
    _check(sizes, "sizes", torch.int32, 1)
    nb = row_off.shape[0]
    d = base.shape[1]
    if queries.shape != (nb * qb, d):
        raise ValueError(f"queries shape {tuple(queries.shape)} != "
                         f"({nb}*{qb}, {d})")
    if sizes.shape[0] != nb:
        raise ValueError(f"sizes has {sizes.shape[0]} entries, row_off {nb}")
    if cap % 128 or cap <= 0:
        raise ValueError(f"cap={cap} must be a positive multiple of 128")
    if nb <= 0 or qb <= 0 or nb * qb >= 2**31:
        raise ValueError(f"{nb} blocks x {qb} queries; the kernel takes "
                         "1 <= nb * qb < 2^31 query rows")
    if base.shape[0] + cap >= 2**31:
        raise ValueError(f"{base.shape[0]} base rows + cap {cap} must stay "
                         "under 2^31 (TMA row coordinates are int32)")
    if d == 0:
        raise ValueError("points have no dimensions")
    if metric not in ("l2", "mips"):
        raise ValueError(f"unknown metric {metric!r}")
    dev = queries.device
    if not (base.device == row_off.device == sizes.device == dev):
        raise ValueError("all inputs must be on one device")
    # TMA needs 16-byte-aligned rows: a d that is no multiple of 4 is copied
    # into zero-padded columns for this call, a misaligned view is cloned
    if d % 4:
        pad = (0, 4 - d % 4)
        queries = torch.nn.functional.pad(queries, pad)
        base = torch.nn.functional.pad(base, pad)
        d = base.shape[1]
    if queries.data_ptr() % 16:
        queries = queries.clone()
    if base.data_ptr() % 16:
        base = base.clone()
    if base.shape[0] == 0:  # a map needs one row; every window is empty
        base = base.new_zeros((1, d))
    L = cap // 128
    mins = torch.empty((nb * qb, 2 * L), dtype=torch.float32, device=dev)
    argmins = torch.empty((nb * qb, 2 * L), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().bintop2_blocks(
            queries.data_ptr(), base.data_ptr(), row_off.data_ptr(),
            sizes.data_ptr(), mins.data_ptr(), argmins.data_ptr(),
            nb, qb, cap, d, base.shape[0], int(metric == "mips"), stream)
    if err != 0:
        raise RuntimeError(
            f"bintop2 launch failed: " + (f"CUDA error {err}" if err > 0 else
                                          f"tensor map not encoded or too few "
                                          f"registers ({err}; see bintop2.cu)"))
    LAUNCHES[entry] += 1
    return mins, argmins
