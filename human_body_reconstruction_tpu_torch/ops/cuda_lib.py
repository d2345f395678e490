"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The sources are compiled by hand with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc -c`` per source, all started together, then linked into one library
with a plain C interface, loaded with ``ctypes``.  The build happens at first
use, into ``human_body_reconstruction_tpu_torch/build/`` (which git ignores),
under a name keyed on a hash of the sources and headers, so a checkout builds
exactly what it holds.  Nothing here runs at import time: the CPU tests
import every module on machines with no CUDA toolkit.  The last two
functions are the tolerance the backward kernels are held to against their
plain versions, by the tests and by chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
MAX_LEVELS = 16            # HBR_MAX_LEVELS in csrc/levels.cuh
# Budget of the dense backward's block-private shared-memory accumulator of
# its leading levels: at the flagship width the coarsest dense grid (47 KB,
# four blocks an SM), where a ray's samples from every block would otherwise
# contend for the same few L2 words.
BWD_SHARED_BYTES = 96 * 1024
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class HbrLevels(ctypes.Structure):
    """Mirror of ``struct HbrLevels`` in csrc/levels.cuh."""

    _fields_ = [("n_levels", ctypes.c_int),
                ("size", ctypes.c_int * MAX_LEVELS),
                ("offset", ctypes.c_int * MAX_LEVELS),
                ("scale", ctypes.c_float * MAX_LEVELS)]


def make_levels(sizes, offsets, scales) -> HbrLevels:
    if len(sizes) > MAX_LEVELS:
        raise ValueError(f"{len(sizes)} levels; the kernels take at most "
                         f"{MAX_LEVELS}")
    lv = HbrLevels()
    lv.n_levels = len(sizes)
    for l, (g, off, s) in enumerate(zip(sizes, offsets, scales)):
        lv.size[l], lv.offset[l], lv.scale[l] = int(g), int(off), float(s)
    return lv


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhbr_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> tuple[Path, str]:
    """Compile csrc/*.cu unless this exact source set is built already.

    Returns (library path, compiler log); the log holds ``-Xptxas -v``'s
    register and shared-memory counts of each kernel when it was built now.
    """
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
            *[str(o) for o in objs]]
    try:
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out, "".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hbr_cp_forward.argtypes = [p, p, i, ll, i, i, i,
                                   ctypes.POINTER(HbrLevels), p, ll, p]
    lib.hbr_cp_forward.restype = i
    lib.hbr_dense_forward.argtypes = [p, p, p, i, p, i, ll, i,
                                      ctypes.POINTER(HbrLevels), p, ll, p]
    lib.hbr_dense_forward.restype = i
    lib.hbr_cp_backward.argtypes = [p, p, i, p, ll, ll, i, i, i, i,
                                    ctypes.POINTER(HbrLevels), p, p]
    lib.hbr_cp_backward.restype = i
    lib.hbr_dense_backward.argtypes = [p, p, p, i, i, p, ll, ll, i,
                                       ctypes.POINTER(HbrLevels), i, p, p]
    lib.hbr_dense_backward.restype = i
    lib.hbr_hash_forward.argtypes = [p, p, p, p, p, ll, i, i, i,
                                     ctypes.POINTER(HbrLevels), p, ll, p, p]
    lib.hbr_hash_forward.restype = i
    f32 = ctypes.c_float
    lv = ctypes.POINTER(HbrLevels)
    lib.hbr_hash_backward.argtypes = [p, p, p, p, p, p, p, p, ll, ll, i, i, i,
                                      f32, lv, p, p]
    lib.hbr_hash_backward.restype = i
    for name, args in (
            ("hbr_hash_pack", [p, ll, ll, i, i, p, p, p]),
            ("hbr_hash_packed_forward", [p, p, p, p, p, p, ll, i, i, i, lv, p,
                                         ll, p, p]),
            ("hbr_hash_cell_forward", [p, p, p, p, ll, i, i, lv, p, ll, p]),
            ("hbr_hash_cell_backward", [p, p, p, p, ll, ll, i, i, lv, p, p]),
            ("hbr_hash_pairs", [p, p, p, p, p, p, p, p, ll, ll, i, i, f32, lv,
                                p, p, p]),
            ("hbr_scatter_sorted", [p, p, ll, i, p, p, p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    lib.hbr_scatter_work_bytes.argtypes = [ll, i]
    lib.hbr_scatter_work_bytes.restype = ll
    lib.hbr_uniform_bits.argtypes = [p, ll, i, p, p]
    lib.hbr_uniform_bits.restype = i
    lib.hbr_error_string.argtypes = [i]
    lib.hbr_error_string.restype = ctypes.c_char_p
    lib.hbr_max_levels.argtypes = []
    lib.hbr_max_levels.restype = i
    if lib.hbr_max_levels() != MAX_LEVELS:
        raise RuntimeError("csrc/levels.cuh HBR_MAX_LEVELS != cuda_lib.MAX_LEVELS")
    return lib


def check(code: int, what: str):
    """Raise if a launcher returned a nonzero cudaGetLastError()."""
    if code != 0:
        msg = library().hbr_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_out(out: torch.Tensor, n: int, c: int, device: torch.device,
              name: str = "out"):
    """Validate a caller-given row-strided matrix view (an output to write,
    or an incoming gradient to read): f32 on ``device``, (n, c), unit
    column stride and a row stride of at least c."""
    if (out.dtype != torch.float32 or out.device != device
            or tuple(out.shape) != (n, c) or out.stride(1) != 1
            or (n > 1 and out.stride(0) < c)):
        raise ValueError(
            f"{name} must be float32 ({n}, {c}) on {device} with unit column "
            f"stride; got {out.dtype} {tuple(out.shape)} on {out.device} "
            f"strides {out.stride()}")


def shared_prefix(sizes, budget: int) -> int:
    """How many leading entries of ``sizes`` (each level's accumulator size
    in bytes) fit together in ``budget`` bytes: the coarse levels a backward
    kernel accumulates in shared memory."""
    total, k = 0, 0
    for s in sizes:
        if total + s > budget:
            break
        total, k = total + s, k + 1
    return k


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (elementwise, f32; 0 at 0): the
    tolerance unit of a sum that is rounded to bf16 after being taken in
    another order."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def sum_order_tolerance(ref, abs_sum, bf16: bool):
    """Elementwise bound on |a - ref| where a and ref are f32 sums of the
    same terms taken in two orders (atomics, index_add_), then rounded to
    bf16 when ``bf16``.  ``abs_sum`` is the sum of the terms' absolute
    values S.  Two orders differ by about 2^-24 * S / sqrt(3) when the
    partial sums wander like a random walk, and by up to 2^-24 * S * sqrt(n)
    / 2 when they drift before cancelling (n terms), so the bound allows
    2^-18 * S; the bf16 rounding of two sums that straddle a rounding
    boundary adds one bf16 ulp of ref; 1e-6 covers zeros.  At the training
    path's 768,000 points, the plain backwards summed in another point
    order read up to 0.99 of it, and a dropped point, swapped lerp weights
    or an unrounded dT read 60 to 10^5 times it
    (tests/test_torch_kernels.py::test_sum_order_tolerance_rejects_faults)."""
    tol = 2.0 ** -18 * abs_sum + 1e-6
    return tol + bf16_ulp(ref) if bf16 else tol
