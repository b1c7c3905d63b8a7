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
* :func:`panda_fk` (``csrc/panda_fk.cu``) — batched Panda forward
  kinematics with the joint origins and axes and, fused, the body points;
  the planner's FK (``models/api.py`` routes a ``PandaModel`` here).  Its
  plain version is ``models/panda.py::fk_batch_tables`` then
  ``points_at``.
* :func:`sdf_query` (``csrc/sdf_query.cu``) — the collision query (hinge
  potentials, world gradients, collision counts) of world points against
  an analytic or a baked scene; ``ops/sdf.py::sdf_potentials_analytic``
  and ``sdf_potentials_baked`` route here.  Its plain versions are
  ``sdf_potentials_analytic_plain`` and ``sdf_potentials_baked_plain``.

Neither of the last two has a Pallas counterpart: the JAX package leaves
both to XLA.  Both are operators of the ``omg_torch`` namespace of a
``torch.library.Library``, so the scene batches' ``torch.func.vmap``
reaches them: their CPU kernel is the plain version, their CUDA kernel the
launch, and a vmap rule folds the mapped axis into the kernel's own batch
axis (configurations for ``panda_fk``, scene rows for ``sdf_query``).
Neither has a gradient: a call on an input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

import torch
from torch import Tensor

from ..models import panda

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
    "panda_fk": ("panda_fk.cu", (), {"omg_panda_fk": _ROLLOUT_ARGS}),
    "sdf_query": ("sdf_query.cu", (), {
        name: [ctypes.POINTER(ctypes.c_void_p),
               ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        for name in ("omg_sdf_query_analytic", "omg_sdf_query_baked")}),
}
_ENTRIES: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "omg_planner_torch are built on a machine with "
                           "the CUDA toolkit")
    return path


def _sources(src: str) -> list:
    """``src`` and every header of ``csrc/`` that it includes, directly or
    through another header, in the order first met."""
    out, todo = [], [src]
    while todo:
        name = todo.pop(0)
        if name in out:
            continue
        out.append(name)
        with open(os.path.join(CSRC, name)) as f:
            todo += re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(),
                               re.MULTILINE)
    return out


def _lib_path(lib: str) -> str:
    """The library's file: named by the hash of its source, the headers it
    includes and the flags, so an edit to any of them rebuilds it."""
    src, flags, _ = _LIBS[lib]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + list(flags)).encode())
    for name in _sources(src):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
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


def _stream(dev) -> int:
    """PyTorch's current stream on CUDA device ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream


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
    status = fn(grid.data_ptr(), points.data_ptr(), out.data_ptr(), g, n,
                _stream(grid.device))
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
    status = fn(ptrs, dims, _stream(dev))
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


# -- the plan kernels' operators ----------------------------------------------
#
# ``panda_fk`` and ``sdf_query`` are operators of one ``torch.library``
# namespace, so the scene batches' ``torch.func.vmap`` reaches them: the CPU
# key runs the plain version, the CUDA key the launch, a vmap rule folds the
# mapped axis into one launch, and the Autograd key raises on an input that
# requires grad (neither has a gradient) and otherwise passes the call on.
# They are registered on a ``Library`` directly, not as ``custom_op``s,
# whose first call imports ``torch._dynamo``, ``sympy`` and
# ``torch.distributed.tensor`` (seconds in every fresh process) and whose
# dispatch costs more host time a call.

_LIB = torch.library.Library("omg_torch", "DEF")


def _no_autograd(op):
    """The Autograd kernel of ``op``: raises when grad mode is on and an
    input requires grad, else runs ``op`` below autograd."""
    def kernel(*args):
        if torch.is_grad_enabled() and any(
                isinstance(a, Tensor) and a.requires_grad for a in args):
            raise RuntimeError(f"{op}: the kernel has no autograd formula "
                               "(no gradient flows through it)")
        with torch._C._AutoDispatchBelowAutograd():
            return op(*args)
    return kernel


def _define(schema: str, cpu, cuda, vmap_rule):
    """Define ``omg_torch::<schema>`` with its CPU, CUDA and Autograd
    kernels and its vmap rule (``vmap_rule(op)``); returns the
    operator."""
    name = schema.split("(")[0]
    _LIB.define(schema)
    op = getattr(torch.ops.omg_torch, name).default
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, _no_autograd(op), "Autograd")
    torch.library.register_vmap(f"omg_torch::{name}", vmap_rule(op),
                                lib=_LIB)
    return op


def _checked(name: str, t: Tensor, device, dtype, shape) -> Tensor:
    """``t``, after checking that it has ``dtype``, lies on ``device`` and
    has ``shape`` (None: any size); raises on anything else."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.shape != shape and (t.ndim != len(shape) or any(
            w is not None and w != n for w, n in zip(shape, t.shape))):
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return t


def _f32_on(name: str, t: Tensor, device, shape) -> Tensor:
    """``t`` as the kernel reads it: float32, on ``device``, of ``shape``,
    contiguous."""
    return _checked(name, t, device, torch.float32, shape).contiguous()


# -- panda_fk ----------------------------------------------------------------

FK_LINKS = panda.NUM_LINKS


def panda_fk_plain(q, pqr, pose_0, center_offset, points,
                   apply_offset: bool = True, with_points: bool = True):
    """Plain version of the ``panda_fk`` kernel, on the arguments of its
    operator: ``models/panda.py::fk_batch_tables``, then ``points_at``
    when ``with_points`` (else x has P = 0)."""
    poses, og, ax = panda.fk_batch_tables(pqr, pose_0, center_offset, q,
                                          True, apply_offset)
    x = (panda.points_at(points, poses) if with_points
         else q.new_zeros(q.shape[0], FK_LINKS, 0, 3))
    return poses, og, ax, x


@functools.lru_cache(maxsize=16)
def _fk_tables(pqr, pose_0, center_offset, points) -> Tensor:
    """A model's tables as the kernel reads them, checked and laid out once
    per model (they are constants, as ``panda.pqr_table`` caches them):
    pqr [7, 3, 4, 4], pose_0 [10, 4, 4], center_offset [10, 4, 4] and
    points [10, P, 3], flat in one float32 buffer on pose_0's device."""
    dev = pose_0.device
    return torch.cat([
        _f32_on("pqr", pqr, dev, (7, 3, 4, 4)).reshape(-1),
        _f32_on("pose_0", pose_0, dev, (FK_LINKS, 4, 4)).reshape(-1),
        _f32_on("center_offset", center_offset, dev,
                (FK_LINKS, 4, 4)).reshape(-1),
        _f32_on("points", points, dev, (FK_LINKS, None, 3)).reshape(-1)])


def _panda_fk_pack(q, pqr, pose_0, center_offset, points, apply_offset,
                   with_points):
    """Check and lay out the C entry point's arguments: (tensors to keep
    alive, (poses, origins, axes, x), the 6 pointers, the 4 ints)."""
    dev = q.device
    q = _f32_on("q", q, dev, (None, 9))
    tables = _fk_tables(pqr, pose_0, center_offset, points)
    if tables.device != dev:
        raise ValueError(f"the model's tables are on {tables.device}, "
                         f"expected {dev}")
    n, p = q.shape[0], points.shape[1]
    if n * FK_LINKS * max(16, 3 * p) >= 2**31:
        raise ValueError("panda_fk: more than 2^31 output values")
    outs = (torch.empty(n, FK_LINKS, 4, 4, dtype=torch.float32, device=dev),
            torch.empty(n, FK_LINKS, 3, dtype=torch.float32, device=dev),
            torch.empty(n, FK_LINKS, 3, dtype=torch.float32, device=dev),
            torch.empty(n, FK_LINKS, p if with_points else 0, 3,
                        dtype=torch.float32, device=dev))
    ptrs = (ctypes.c_void_p * 6)(q.data_ptr(), tables.data_ptr(),
                                 *[t.data_ptr() for t in outs])
    dims = (ctypes.c_int * 4)(n, p, int(apply_offset), int(with_points))
    return (q, tables), outs, ptrs, dims


def _panda_fk_cuda(q, pqr, pose_0, center_offset, points, apply_offset,
                   with_points):
    keep, outs, ptrs, dims = _panda_fk_pack(q, pqr, pose_0, center_offset,
                                            points, apply_offset, with_points)
    if dims[0] == 0:
        return outs
    status = _entry("panda_fk", "omg_panda_fk")(ptrs, dims,
                                                _stream(q.device))
    del keep  # the stream orders any reuse of these blocks after the launch
    if status != 0:
        raise RuntimeError(f"panda_fk launch failed: CUDA error {status}")
    panda_fk.launches += 1
    return outs


def _panda_fk_vmap(op):
    def rule(info, in_dims, q, pqr, pose_0, center_offset, points,
             apply_offset, with_points):
        """vmap rule: the mapped axis of ``q`` folds into the
        configurations (one launch); the model's tables must not be
        mapped."""
        if any(d is not None for d in in_dims[1:5]):
            raise ValueError("panda_fk under vmap: the model's tables must "
                             "be the same for every mapped row")
        args = (pqr, pose_0, center_offset, points, apply_offset,
                with_points)
        if in_dims[0] is None:
            return op(q, *args), (None,) * 4
        q = q.movedim(in_dims[0], 0)
        s, n = q.shape[:2]
        out = op(q.reshape(s * n, q.shape[-1]), *args)
        return tuple(o.reshape(s, n, *o.shape[1:]) for o in out), (0,) * 4
    return rule


_panda_fk_op = _define(
    "panda_fk(Tensor q, Tensor pqr, Tensor pose_0, Tensor center_offset, "
    "Tensor points, bool apply_offset, bool with_points) "
    "-> (Tensor, Tensor, Tensor, Tensor)",
    panda_fk_plain, _panda_fk_cuda, _panda_fk_vmap)


def panda_fk(q: Tensor, pose_0: Tensor, chain_post: Tensor,
             center_offset: Tensor, points: Tensor, apply_offset: bool = True,
             with_points: bool = True):
    """Panda FK of configurations ``q [N, 9]`` on the model's tables (a
    ``PandaModel``'s fields): (link poses [N, 10, 4, 4] (mesh-centre frames
    when ``apply_offset``), world joint origins [N, 10, 3], axes [N, 10,
    3], body points of ``points [10, P, 3]`` [N, 10, P, 3] (P = 0 unless
    ``with_points``)).  The kernel for CUDA tensors (one launch), the
    plain version for CPU tensors; under ``torch.func.vmap`` one call for
    every mapped row."""
    return _panda_fk_op(q, panda.pqr_table(pose_0, chain_post), pose_0,
                        center_offset, points, apply_offset, with_points)


panda_fk.launches = 0


# -- sdf_query ---------------------------------------------------------------

def sdf_query_plain(scene, inv_poses, points, epsilons, padding_scales,
                    clearances, disables):
    """Plain version of the ``sdf_query`` kernel for one scene row, on the
    arguments of :func:`sdf_query`: ``ops/sdf.py``'s
    ``sdf_potentials_baked_plain`` or ``sdf_potentials_analytic_plain``."""
    from . import sdf

    plain = (sdf.sdf_potentials_baked_plain
             if isinstance(scene, sdf.BakedSceneSDF)
             else sdf.sdf_potentials_analytic_plain)
    return plain(scene, inv_poses, points, epsilons, padding_scales,
                 clearances, disables)


def _sdf_query_rows(scene_of, row_args, scene_args):
    """:func:`sdf_query_plain` over B scene rows, one row at a time."""
    outs = [sdf_query_plain(scene_of(*(t[b] for t in scene_args)),
                            *(t[b] for t in row_args))
            for b in range(row_args[0].shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


def _rows(name: str, t: Tensor, device, dtype, shape) -> tuple:
    """(tensor, scene-axis stride in elements) of an input ``[B, ...]``
    as the kernel reads it: each row contiguous, rows ``stride`` apart (0
    where one row is shared, as an ``expand`` leaves it)."""
    t = _checked(name, t, device, dtype, shape)
    if t.shape[0] > 1 and t.stride(0) == 0 and t[0].is_contiguous():
        return t, 0
    t = t.contiguous()
    return t, t.stride(0) if t.shape[0] > 1 else 0


def _sdf_query_pack(row_args, scene_args):
    """Check and lay out the C entry point's arguments for either form
    (``scene_args``: kinds, halfs, penals, rounds of the analytic form, or
    data4, limits of the baked one, each ``[B, O, ...]``): (tensors to
    keep alive, (pot, grad, collide), the 15 pointers, the 16 sizes and
    strides)."""
    inv_poses, points = row_args[:2]
    dev = points.device
    b, p = points.shape[:2]
    o = inv_poses.shape[1]
    f32 = torch.float32
    got = [_rows("points", points, dev, f32, (b, p, 3)),
           _rows("inv_poses", inv_poses, dev, f32, (b, o, 4, 4))]
    got += [_rows(name, t, dev, f32, (b, o)) for name, t in zip(
        ("epsilons", "padding_scales", "clearances", "disables"),
        row_args[2:])]
    v = 0
    if len(scene_args) == 4:
        got += [_rows(key, t, dev, dtype, shape) for key, t, dtype, shape
                in zip(("kinds", "halfs", "penals", "rounds"), scene_args,
                       (torch.int32, f32, f32, f32),
                       ((b, o), (b, o, 3), (b, o), (b, o)))]
        got += [(None, 0)] * 2
    else:
        data4, stride = _rows("data4", scene_args[0], dev, f32,
                              (b, o, None, None, None, 4))
        if data4.data_ptr() % 16:     # read as float4
            data4 = data4.clone()
        v = data4[0, 0].numel() // 4
        got += [(None, 0)] * 4
        got += [(data4, stride // 4),
                _rows("limits", scene_args[1], dev, f32, (b, o, 10))]
    if b * p >= 2**31:
        raise ValueError("sdf_query: more than 2^31 points")
    outs = (torch.empty(b, p, dtype=f32, device=dev),
            torch.empty(b, p, 3, dtype=f32, device=dev),
            torch.empty(b, p, dtype=f32, device=dev))
    ptrs = (ctypes.c_void_p * 15)(
        *[0 if t is None else t.data_ptr() for t, _ in got],
        *[t.data_ptr() for t in outs])
    dims = (ctypes.c_longlong * 16)(b, p, o, v, *[st for _, st in got])
    return [t for t, _ in got], outs, ptrs, dims


def _sdf_query_cuda(entry, row_args, scene_args):
    keep, outs, ptrs, dims = _sdf_query_pack(row_args, scene_args)
    if dims[0] * dims[1] == 0:
        return outs
    status = _entry("sdf_query", entry)(ptrs, dims,
                                        _stream(row_args[1].device))
    del keep  # the stream orders any reuse of these blocks after the launch
    if status != 0:
        raise RuntimeError(f"sdf_query launch failed: CUDA error {status}")
    sdf_query.launches += 1
    return outs


def _sdf_vmap(op):
    def rule(info, in_dims, *args):
        """vmap rule: the mapped axis folds into the scene rows (one
        launch); an unmapped input is shared by every row."""
        s = info.batch_size
        rows = [(a.expand(s, *a.shape) if d is None else a.movedim(d, 0))
                .flatten(0, 1) for a, d in zip(args, in_dims)]
        out = op(*rows)
        return tuple(o.unflatten(0, (s, -1)) for o in out), (0, 0, 0)
    return rule


_SDF_ROWS = ("Tensor inv_poses, Tensor points, Tensor epsilons, "
             "Tensor padding_scales, Tensor clearances, Tensor disables")


def _sdf_analytic_cpu(inv_poses, points, epsilons, padding_scales,
                      clearances, disables, kinds, halfs, penals, rounds):
    from .sdf import AnalyticScene

    return _sdf_query_rows(
        AnalyticScene,
        (inv_poses, points, epsilons, padding_scales, clearances, disables),
        (kinds, halfs, penals, rounds))


def _sdf_analytic_cuda(inv_poses, points, epsilons, padding_scales,
                       clearances, disables, kinds, halfs, penals, rounds):
    return _sdf_query_cuda(
        "omg_sdf_query_analytic",
        (inv_poses, points, epsilons, padding_scales, clearances, disables),
        (kinds, halfs, penals, rounds))


def _sdf_baked_cpu(inv_poses, points, epsilons, padding_scales, clearances,
                   disables, data4, limits):
    from .sdf import BakedSceneSDF

    return _sdf_query_rows(
        BakedSceneSDF,
        (inv_poses, points, epsilons, padding_scales, clearances, disables),
        (data4, limits))


def _sdf_baked_cuda(inv_poses, points, epsilons, padding_scales, clearances,
                    disables, data4, limits):
    return _sdf_query_cuda(
        "omg_sdf_query_baked",
        (inv_poses, points, epsilons, padding_scales, clearances, disables),
        (data4, limits))


_sdf_analytic_op = _define(
    f"sdf_query_analytic({_SDF_ROWS}, Tensor kinds, Tensor halfs, "
    "Tensor penals, Tensor rounds) -> (Tensor, Tensor, Tensor)",
    _sdf_analytic_cpu, _sdf_analytic_cuda, _sdf_vmap)
_sdf_baked_op = _define(
    f"sdf_query_baked({_SDF_ROWS}, Tensor data4, Tensor limits) "
    "-> (Tensor, Tensor, Tensor)",
    _sdf_baked_cpu, _sdf_baked_cuda, _sdf_vmap)


def sdf_query(scene, inv_poses: Tensor, points: Tensor, epsilons: Tensor,
              padding_scales: Tensor, clearances: Tensor, disables: Tensor):
    """(potentials [P], world gradients [P, 3], collision counts [P]) of
    world points ``[P, 3]`` against every object of ``scene`` (an
    ``AnalyticScene`` or a ``BakedSceneSDF``; ``inv_poses [O, 4, 4]``,
    the rest ``[O]``): the kernel for CUDA tensors (one launch), the plain
    version for CPU tensors; under ``torch.func.vmap`` one call for every
    mapped row."""
    from .sdf import BakedSceneSDF

    rows = tuple(t[None] for t in (inv_poses, points, epsilons,
                                   padding_scales, clearances, disables))
    if isinstance(scene, BakedSceneSDF):
        out = _sdf_baked_op(*rows, scene.data4[None], scene.limits[None])
    else:
        out = _sdf_analytic_op(*rows, scene.kinds[None], scene.halfs[None],
                               scene.penals[None], scene.rounds[None])
    return tuple(o[0] for o in out)


sdf_query.launches = 0

# every kernel wrapper of the package, for launch accounting
KERNELS = {"min_dist_grid": min_dist_grid, "rigid_rollout": rigid_rollout,
           "panda_fk": panda_fk, "sdf_query": sdf_query}
