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
* :func:`rigid_rollout` (``csrc/rigid_rollout.cu``) — the physics
  executor's whole substep loop, one thread block per rollout (8 warps
  score the contact candidates, one warp solves).  It has no
  Pallas counterpart (the JAX package runs that ``lax.scan`` in XLA on the
  host CPU); its plain version is ``physics/rigid.py::rollout_plain``, and
  ``physics/rigid.py::rollout`` picks one or the other by device.
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

_ROLLOUT_ARGS = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                 ctypes.c_void_p]
# library -> (source file, extra nvcc flags, {C entry point: argtypes}).
# ``rigid_rollout_cycles`` is the rollout kernel built with its per-phase
# cycle counters (``-DOMG_ROLLOUT_CYCLES``): a profile of the kernel, which
# no wrapper of the main path loads.
_LIBS = {
    "min_dist_grid": ("min_dist_grid.cu", (), {
        "omg_min_dist_grid": [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p],
        "omg_min_dist_grid_layout": [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)],
    }),
    "rigid_rollout": ("rigid_rollout.cu", (), {
        "omg_rigid_rollout": _ROLLOUT_ARGS}),
    "rigid_rollout_cycles": ("rigid_rollout.cu", ("-DOMG_ROLLOUT_CYCLES",), {
        "omg_rigid_rollout_cycles": _ROLLOUT_ARGS}),
}
_ENTRIES: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "omg_planner_torch are built on a machine with "
                           "the CUDA toolkit")
    return path


def _lib_path(lib: str) -> str:
    src, flags, _ = _LIBS[lib]
    with open(os.path.join(CSRC, src), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            NVCC_FLAGS + list(flags)).encode())
    return os.path.join(BUILD_DIR, f"lib{lib}_{digest.hexdigest()[:16]}.so")


def build(extra_flags: tuple = (), libs=None) -> dict:
    """Compile every library of ``libs`` (default: all) that is missing, or
    all of them when ``extra_flags`` are given: one ``nvcc`` per library,
    all started together.  Returns {library: compiler output} for the
    libraries it built; raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for lib in (_LIBS if libs is None else libs):
        src, flags, _ = _LIBS[lib]
        out = _lib_path(lib)
        if os.path.exists(out) and not extra_flags:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, *extra_flags, "-o", tmp,
               os.path.join(CSRC, src)]
        procs[lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs = {}
    for lib, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {lib}:\n{log}")
        os.replace(tmp, out)
        logs[lib] = log
    return logs


def _entry(lib: str, name: str):
    """The loaded C entry point ``name`` of library ``lib`` (building it if
    needed)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        path = _lib_path(lib)
        if not os.path.exists(path):
            build(libs=[lib])
        fn = getattr(ctypes.CDLL(path), name)
        fn.argtypes = _LIBS[lib][2][name]
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
    fn = _entry("min_dist_grid", "omg_min_dist_grid")
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
    fn = _entry("min_dist_grid", "omg_min_dist_grid_layout")
    status = fn(g, n, info)
    if status != 0:
        raise RuntimeError(f"min_dist_grid layout failed: CUDA error {status}")
    return dict(zip(("blocks", "threads", "smem_bytes", "blocks_per_sm",
                     "sms", "units", "unit_cells"), info))


def _dev_f32(name: str, t: torch.Tensor, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    return t.to(torch.float32).contiguous()


#: contact lanes the rollout kernel takes: its one solving warp holds 4
#: lanes a thread up to 128 lanes, 8 up to 256
MAX_ROLLOUT_LANES = 256


def _rigid_rollout_pack(spec, world, pp, state0, sph_track, is_finger,
                        pad_track, pad_samples, pad_axis, jv_track, jv_ref,
                        k_robot, k_pad, k_world, iters):
    """Check shapes and lay out the C entry point's arguments: (tensors to
    keep alive, out_state [B, 13], out_trace [B, T, 19], the 23 pointers,
    the 13 ints)."""
    from ..physics.rigid import TRACE_FIELDS

    dev = sph_track.device
    b, t1, k = sph_track.shape[:3]
    sp = pad_samples.shape[1]
    s = spec.surf.shape[0]
    if sph_track.shape != (b, t1, k, 3) or t1 < 2:
        raise ValueError(f"sph_track must be [B, T+1, K, 3] with T >= 1, got "
                         f"{tuple(sph_track.shape)}")
    shapes = {"pad_track": (pad_track, (b, t1, 2, 4, 4)),
              "pad_samples": (pad_samples, (2, sp, 3)),
              "pad_axis": (pad_axis, (b, 2, 3)),
              "jv_track": (jv_track, (b, t1, 2)), "jv_ref": (jv_ref, (b, 2)),
              "is_finger": (is_finger, (k,))}
    for name, (a, want) in shapes.items():
        if tuple(a.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(a.shape)}")
    kr, kp, kw = min(k_robot, k), min(k_pad, 2 * sp), min(k_world, s)
    if kr + kp + kw > MAX_ROLLOUT_LANES:
        raise ValueError(f"rigid_rollout: {kr + kp + kw} contact lanes, at "
                         f"most {MAX_ROLLOUT_LANES} (8 a thread of the "
                         "solving warp)")

    def f(name, a):
        return _dev_f32(name, a, dev)

    state = f("state0", torch.cat([state0.x, state0.q, state0.v, state0.w],
                                  -1))
    params = f("params", torch.cat([torch.stack(list(pp[:-1])),
                                    pp.gravity]))
    body = f("spec", torch.cat([spec.kind.to(torch.float32)[None],
                                spec.half, spec.round[None],
                                spec.inv_mass[None],
                                spec.inv_inertia.reshape(9)]))
    def f4(name, a):        # read as float4: 16-byte aligned rows of 4
        a = f(name, a)
        return a if a.data_ptr() % 16 == 0 else a.clone()

    grid4 = f4("spec.grid4", spec.grid4)
    n_grid = world.grid4.shape[0] if world.grid4 is not None else 0
    empty = torch.zeros(0, dtype=torch.float32, device=dev)
    wg = f4("world.grid4", world.grid4) if n_grid else empty
    keep = [
        f("sph_track", sph_track), f("is_finger", is_finger),
        f("pad_track", pad_track), f("pad_samples", pad_samples),
        f("pad_axis", pad_axis), f("jv_track", jv_track),
        f("jv_ref", jv_ref), state, params, body, f("spec.surf", spec.surf),
        grid4, f("spec.grid_limits", spec.grid_limits),
        world.kinds.to(device=dev, dtype=torch.int32).contiguous(),
        f("world.halfs", world.halfs), f("world.rounds", world.rounds),
        f("world.inv_poses", world.inv_poses), f("world.mask", world.mask),
        wg, f("world.grid_limits", world.grid_limits) if n_grid else empty,
        f("world.grid_inv_poses", world.grid_inv_poses) if n_grid else empty,
    ]
    width = sum(n for _, n in TRACE_FIELDS)
    out_state = torch.empty(b, 13, dtype=torch.float32, device=dev)
    out_trace = torch.empty(b, t1 - 1, width, dtype=torch.float32,
                            device=dev)
    ptrs = (ctypes.c_void_p * 23)(*[a.data_ptr() for a in keep],
                                   out_state.data_ptr(), out_trace.data_ptr())
    dims = (ctypes.c_int * 13)(
        b, t1 - 1, k, sp, s, world.kinds.shape[0], n_grid,
        wg.shape[1] if n_grid else 0, grid4.shape[0], kr, kp, kw, iters)
    return keep, out_state, out_trace, ptrs, dims


def _rigid_rollout_unpack(out_state, out_trace):
    """(final BodyState, traces) from the kernel's packed outputs."""
    from ..physics.rigid import TRACE_FIELDS, BodyState

    final = BodyState(x=out_state[:, 0:3], q=out_state[:, 3:7],
                      v=out_state[:, 7:10], w=out_state[:, 10:13])
    traces, at = {}, 0
    for name, n in TRACE_FIELDS:
        col = out_trace[..., at:at + n]
        traces[name] = col[..., 0] if n == 1 else col
        at += n
    return final, traces


def _launch_rollout(lib: str, name: str, args, kw, cycles: bool = False):
    """Pack, launch ``name`` of ``lib`` on the current stream, unpack;
    with ``cycles`` the launch also fills the [B, 6] int64 per-phase cycle
    counts of the profile build (appended to the pointers)."""
    dev = args[4].device
    if dev.type != "cuda":
        raise ValueError(f"rigid_rollout: tensors on {dev}; the kernel runs "
                         "on cuda (physics.rigid.rollout takes the plain "
                         "version on the CPU)")
    keep, out_state, out_trace, ptrs, dims = _rigid_rollout_pack(
        *args, kw.get("k_robot", 48), kw.get("k_pad", 32),
        kw.get("k_world", 48), kw.get("iters", 48))
    out_cyc = None
    if cycles:
        out_cyc = torch.zeros(dims[0], len(ROLLOUT_PHASES), dtype=torch.int64,
                              device=dev)
        ptrs = (ctypes.c_void_p * (len(ptrs) + 1))(*ptrs,
                                                   out_cyc.data_ptr())
    fn = _entry(lib, name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(ptrs, dims, stream)
    del keep  # the stream orders any reuse of these blocks after the launch
    if status != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {status}")
    return _rigid_rollout_unpack(out_state, out_trace), out_cyc


def rigid_rollout(spec, world, pp, state0, sph_track, is_finger, pad_track,
                  pad_samples, pad_axis, jv_track, jv_ref, k_robot: int = 48,
                  k_pad: int = 32, k_world: int = 48, iters: int = 48):
    """Launch the rollout kernel on CUDA tensors, batched as
    ``physics/rigid.py::rollout`` documents (every argument given, leading
    B on the state and the tracks).  One launch for the whole batch; raises
    for tensors off the card (``rigid.rollout`` runs the plain version on
    the CPU) and when the launch fails.  Returns (final BodyState,
    traces)."""
    out, _ = _launch_rollout(
        "rigid_rollout", "omg_rigid_rollout",
        (spec, world, pp, state0, sph_track, is_finger, pad_track,
         pad_samples, pad_axis, jv_track, jv_ref),
        dict(k_robot=k_robot, k_pad=k_pad, k_world=k_world, iters=iters))
    rigid_rollout.launches += 1
    return out


rigid_rollout.launches = 0

#: the phases of a substep that the profile build times, in its order
ROLLOUT_PHASES = ("scoring", "rank", "lane_setup", "jacobi", "pseudo",
                  "pools_integration")


def rigid_rollout_cycles(*args, **kw):
    """The profile build of the rollout kernel (``-DOMG_ROLLOUT_CYCLES``,
    its own library) on the arguments of :func:`rigid_rollout`: the same
    rollout, plus the ``clock64()`` cycles that each block spent in each
    phase of :data:`ROLLOUT_PHASES`, summed over the substeps, [B, 6]
    int64.  A measurement tool, not a path of the package: it is never
    counted as a launch of ``rigid_rollout``.  Returns (final, traces,
    cycles)."""
    (final, traces), cyc = _launch_rollout(
        "rigid_rollout_cycles", "omg_rigid_rollout_cycles", args, kw,
        cycles=True)
    return final, traces, cyc


# every kernel wrapper of the package, for launch accounting
KERNELS = {"min_dist_grid": min_dist_grid, "rigid_rollout": rigid_rollout}
