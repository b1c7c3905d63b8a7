"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(counterpart of ``omg_planner_tpu/ops/pallas_kernels.py``).

Each kernel's source lives in ``omg_planner_torch/csrc/``.  It is compiled
at first use with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C entry point under ``build/omg_torch_kernels/`` (rebuilt when the
source's hash changes) and called through ``ctypes`` on PyTorch's current
stream.  A wrapper takes its plain version only for tensors on the CPU;
for a CUDA tensor it launches the kernel or raises.  Each wrapper counts
its launches in a plain integer attribute, ``<wrapper>.launches``.

Kernels:

* :func:`min_dist_grid` (``csrc/min_dist_grid.cu``) — nearest-point
  distance of every grid cell, replacing the Pallas kernel
  ``omg_planner_tpu/ops/pallas_kernels.py::min_dist_grid``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "omg_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# source file -> {C entry point: argtypes}
_SOURCES = {
    "min_dist_grid.cu": {
        "omg_min_dist_grid": [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p],
        "omg_min_dist_grid_layout": [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)],
    },
}
_ENTRIES: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "omg_planner_torch are built on a machine with "
                           "the CUDA toolkit")
    return path


def _lib_path(src: str) -> str:
    with open(os.path.join(CSRC, src), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(extra_flags: tuple = ()) -> dict:
    """Compile every kernel source whose library is missing, one ``nvcc``
    per source, all started together.  Returns {source: compiler output}
    for the sources it built; raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for src in _SOURCES:
        out = _lib_path(src)
        if os.path.exists(out) and not extra_flags:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
               os.path.join(CSRC, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs = {}
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)
        logs[src] = log
    return logs


def _entry(src: str, name: str):
    """The loaded C entry point ``name`` of ``src`` (building it if
    needed)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        path = _lib_path(src)
        if not os.path.exists(path):
            build()
        fn = getattr(ctypes.CDLL(path), name)
        fn.argtypes = _SOURCES[src][name]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _check_points(name: str, t: torch.Tensor, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != 2 or t.shape[1] != 3:
        raise ValueError(f"{name} must be [n, 3], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def min_dist_grid_plain(grid: torch.Tensor, points: torch.Tensor,
                        chunk: int = 16384) -> torch.Tensor:
    """Plain PyTorch version: ``min_dist_grid_xla``'s expansion
    ``|g|^2 + |p|^2 - 2 g.p``, chunked over cells so memory stays
    O(chunk x N).  Returns [G] float32."""
    p2 = torch.sum(points**2, dim=1)[None, :]
    outs = []
    for g in torch.split(grid, chunk):
        g2 = torch.sum(g**2, dim=1, keepdim=True)
        d2 = g2 + p2 - 2.0 * (g @ points.T)
        outs.append(torch.sqrt(torch.clamp(d2.amin(dim=1), min=0.0)))
    if not outs:
        return grid.new_zeros(0)
    return torch.cat(outs)


def min_dist_grid(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Min distance from each grid cell ``[G, 3]`` to the point set
    ``[N, 3]``: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Returns [G] float32."""
    if grid.device.type == "cpu":
        return min_dist_grid_plain(grid, points)
    if grid.device.type != "cuda":
        raise ValueError(f"min_dist_grid: unsupported device {grid.device}")
    _check_points("grid", grid, grid.device)
    _check_points("points", points, grid.device)
    g, n = grid.shape[0], points.shape[0]
    if g >= 2**31 // 3 or n >= 2**31 // 3:
        raise ValueError("min_dist_grid: more than 2^31 coordinates")
    fn = _entry("min_dist_grid.cu", "omg_min_dist_grid")
    out = torch.empty(g, dtype=torch.float32, device=grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(grid.data_ptr(), points.data_ptr(), out.data_ptr(),
                    g, n, stream)
    if status != 0:
        raise RuntimeError(f"min_dist_grid launch failed: CUDA error {status}")
    min_dist_grid.launches += 1
    return out


min_dist_grid.launches = 0


def min_dist_grid_layout(g: int, n: int) -> dict:
    """The launch :func:`min_dist_grid` makes for ``g`` cells and ``n``
    points on the current CUDA device: blocks (one per SM at most),
    threads per block, dynamic shared memory bytes, resident blocks per SM,
    SMs, warp units and cells per unit."""
    info = (ctypes.c_int * 7)()
    fn = _entry("min_dist_grid.cu", "omg_min_dist_grid_layout")
    status = fn(g, n, info)
    if status != 0:
        raise RuntimeError(f"min_dist_grid layout failed: CUDA error {status}")
    return dict(zip(("blocks", "threads", "smem_bytes", "blocks_per_sm",
                     "sms", "units", "unit_cells"), info))

# every kernel wrapper of the package, for launch accounting
KERNELS = {"min_dist_grid": min_dist_grid}
