"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by its own `nvcc` process (all started together)
for `sm_90a`, and the objects are linked into one shared library with a
plain C interface, loaded through ctypes.  The library is built at first
use into `build/kernels/` beside the package (git-ignored), named by a hash
of the sources and flags so an edited source rebuilds.  No PyTorch headers
are compiled: the wrappers pass raw device pointers and the current CUDA
stream, and each C entry point returns `cudaGetLastError()`.

Nothing here runs at import time; the CPU tests import every module of the
package on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("hash_encode.cu", "march.cu", "composite.cu", "vm_sample.cu")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# no --use_fast_math: the march must reproduce the plain version's f32
# arithmetic bit for bit (IEEE division, no flushed denormals)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_LEVELS = 32  # csrc/hash_encode.cu PVD_MAX_LEVELS
MAX_BAKED_LEVELS = 8  # csrc/hash_encode.cu PVD_MAX_BAKED


class HashLevels(ctypes.Structure):
    """The level list of one K1, K7, K10, K11, K12, K13, K15 or K16 launch
    and its per-level constants, passed by value (csrc/hash_encode.cu):
    entry i fills level slot `level[i]` of a row of `out_levels` slots."""

    _fields_ = [
        ("n_levels", ctypes.c_int),
        ("out_levels", ctypes.c_int),
        ("hash_mask", ctypes.c_uint32),
        ("level", ctypes.c_int * MAX_LEVELS),
        ("offset", ctypes.c_int * MAX_LEVELS),
        ("side", ctypes.c_int * MAX_LEVELS),
        ("hashed", ctypes.c_int * MAX_LEVELS),
        ("scale", ctypes.c_float * MAX_LEVELS),
    ]


class MarchParams(ctypes.Structure):
    """Static march settings of K2 and K14, passed by value
    (csrc/march.cu)."""

    _fields_ = [
        ("n_rays", ctypes.c_int),
        ("n_steps", ctypes.c_int),
        ("max_samples", ctypes.c_int),
        ("grid", ctypes.c_int),
        ("cascades", ctypes.c_int),
        ("bound", ctypes.c_float),
        ("dt_min", ctypes.c_float),
        ("mip_bound0", ctypes.c_float),
        ("dt_gamma", ctypes.c_float),
        ("dt_max", ctypes.c_float),
    ]


class VMTables(ctypes.Structure):
    """The three VM branches' tables of K4/K5, passed by value
    (csrc/vm_sample.cu)."""

    _fields_ = [
        ("plane", ctypes.c_void_p * 3),
        ("line", ctypes.c_void_p * 3),
        ("H", ctypes.c_int * 3),
        ("W", ctypes.c_int * 3),
        ("L", ctypes.c_int * 3),
    ]


_P = ctypes.c_void_p
_SIGNATURES = {
    # x01, table, out, n_points, levels, stream
    "pvd_hash_encode_fwd": (_P, _P, _P, ctypes.c_longlong, HashLevels, _P),
    # x01, g [n, L*2], grad_table (zeroed), n_points, levels, stream
    "pvd_hash_encode_bwd": (_P, _P, _P, ctypes.c_longlong, HashLevels, _P),
    # x01, cell_table [Tc, 16], out, n_points, cell levels, stream
    "pvd_hash_cell_fwd": (_P, _P, _P, ctypes.c_longlong, HashLevels, _P),
    # x01, g [n, L*2] (8-byte aligned), grad_cell (zeroed), n_points, cell
    # levels, stream
    "pvd_hash_cell_bwd": (_P, _P, _P, ctypes.c_longlong, HashLevels, _P),
    "pvd_hash_cell_vector_atomics": (),
    # K12 / K13: as pvd_hash_encode_fwd / _bwd, x01 [n, 2]
    "pvd_hash_encode2_fwd": (_P, _P, _P, ctypes.c_longlong, HashLevels, _P),
    "pvd_hash_encode2_bwd": (_P, _P, _P, ctypes.c_longlong, HashLevels, _P),
    # K15: x01, baked [side_f^3, Ld*2], out [n, L*2], n_points, levels,
    # stream
    "pvd_hash_baked_fwd": (_P, _P, _P, ctypes.c_longlong, HashLevels, _P),
    # K16: table, b [Ld, side_f] int32, f [Ld, side_f], baked, side_f,
    # levels, stream
    "pvd_hash_bake": (_P, _P, _P, _P, ctypes.c_int, HashLevels, _P),
    # rays_o, rays_d, nears, fars, u (nullable), bitfield, params,
    # t, dt, mask, delta_depth, t0, stream
    "pvd_march_rays": (_P, _P, _P, _P, _P, _P, MarchParams,
                       _P, _P, _P, _P, _P, _P),
    # K14 (dt_gamma > 0): the same arguments
    "pvd_march_rays_geom": (_P, _P, _P, _P, _P, _P, MarchParams,
                            _P, _P, _P, _P, _P, _P),
    # sigmas, rgbs, dt, t_cum, ray_id, valid, n_samples, n_rays,
    # early_stop, lanes per ray, bounds (out [2, N] int32, for K6),
    # weights, weights_sum, depth, image, stream
    "pvd_composite_compact_fwd": (_P, _P, _P, _P, _P, _P, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  _P, _P, _P, _P, _P, _P),
    # sigmas, rgbs, dt, t_cum, weights, bounds (from the forward), ray_id,
    # valid, n_samples, n_rays, lanes per ray, g_ws, g_depth, g_image,
    # g_weights, d_sigma, d_rgb, stream
    "pvd_composite_compact_bwd": (_P, _P, _P, _P, _P, _P, _P, _P,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  _P, _P, _P, _P, _P, _P, _P),
    # sigmas, rgbs, dt, delta_depth, mask [N, S], n_rays, S, early_stop,
    # weights, weights_sum, depth, image, stream
    "pvd_composite_padded_fwd": (_P, _P, _P, _P, _P, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                                 _P),
    # sigmas, rgbs, dt, delta_depth, mask, weights (from the forward),
    # n_rays, S, g_ws, g_depth, g_image, g_weights, d_sigma, d_rgb, stream
    "pvd_composite_padded_bwd": (_P, _P, _P, _P, _P, _P, ctypes.c_int,
                                 ctypes.c_int, _P, _P, _P, _P, _P, _P, _P),
    # tables, xn, out [3, n, R], n, R, vec4 (float4 lanes), lanes per
    # sample, stream
    "pvd_vm_sample_fwd": (VMTables, _P, _P, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _P),
    # tables, grads (zeroed), xn, g [3, n, R], n, R, vec4 (float4 lanes),
    # lanes per sample, stream
    "pvd_vm_sample_bwd": (VMTables, VMTables, _P, _P, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the GPU")
    return found


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libpvd_kernels_{_source_key()}.so"


def build() -> Path:
    """Compile the sources (one nvcc each, in parallel) and link the .so.

    Writes the compiler's resource report (-Xptxas -v) next to the library
    as `<lib>.log`.  Builds in a temporary directory and renames, so
    processes building at once never load a half-written library.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {name}\n{text}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(logs))
        so_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(so_tmp), *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        Path(str(so_tmp) + ".log").write_text("\n".join(logs))
        os.replace(str(so_tmp) + ".log", str(out) + ".log")
        os.replace(so_tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call a kernel entry point; raise on the CUDA error it reports."""
    rc = getattr(load(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, **tensors) -> torch.device:
    """All tensors on one CUDA device and contiguous; returns the device."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {dev}")
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return dev


def build_seconds() -> float:
    """Build (or find) and load the library; seconds it took."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0
