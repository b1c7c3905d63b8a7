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
* :func:`md_update` (``csrc/md_update.cu``) — the MD learner's expert
  update (the Bregman projections' fixed-point loop, the experts' costs,
  the q recurrence and the mixture), one block a scene row;
  ``ops/learner.py::update_goal_dist`` routes its MD branch here.  Its
  plain version is :func:`md_update_plain`.
* :func:`joint_limit` (``csrc/joint_limit.cu``) — the CHOMP step's
  smoothed joint-limit projection loop, one block a scene row;
  ``ops/chomp.py::handle_joint_limit`` and ``handle_joint_limit_batch``
  route here.  Its plain version is :func:`joint_limit_plain`.
* :func:`ik_prefilter` and :func:`ik_chain` (``csrc/ik_newton.cu``) — the
  goal-set build's damped-Newton IK: the two-stage prefilter's fixed
  sweep and the fused standoff chain, one warp a lane, four lanes a
  block;
  ``ops/ik.py::ik_batch_fixed`` and ``_solve_chain_fused`` route here.
  Their plain versions are :func:`ik_prefilter_plain` and
  :func:`ik_chain_plain`.
* :func:`chomp_obstacle` and :func:`chomp_step` (``csrc/chomp_cost.cu``)
  — the CHOMP plan step after FK and the collision query: the obstacle
  cost and its configuration-space gradient with the exact top-k mask,
  then smoothness, the total loss, the termination flags and the update,
  one block a scene row each; ``ops/chomp.py::compute_collision_loss``
  and ``chomp_step`` route here.  Their plain versions are
  :func:`chomp_obstacle_plain` and :func:`chomp_step_plain`.

None of the last eight has a Pallas counterpart: the JAX package leaves
them to XLA (``md_update``, ``joint_limit`` and ``ik_chain`` replace its
``lax.while_loop``s, which in eager PyTorch read the host on every pass;
the CHOMP kernels ~150 eager operations a plan step).  All eight are
operators of the ``omg_torch`` namespace of a ``torch.library.Library``,
so the scene batches' ``torch.func.vmap`` reaches them: their CPU kernel
is the plain version, their CUDA kernel the launch, and a vmap rule
folds the mapped axis into the kernel's own batch axis (configurations
for ``panda_fk``, IK lanes for the IK, scene rows for the others).  None
has a gradient: a call on an input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys

import torch
from torch import Tensor

from ..config import DIFF_RULE_LENGTH, DIFF_RULES
from ..models import panda
from ..utils import graphs
from ..utils.diff import derivative
from ..utils.linalg import solve_spd_unrolled, top_k
from ..utils.pose import so3_log
from ..utils.sync import host_bool

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
    "md_update": ("md_update.cu", (), {
        "omg_md_update": [ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                          ctypes.c_void_p],
        "omg_empty_launch": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}),
    "joint_limit": ("joint_limit.cu", (), {"omg_joint_limit": [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]}),
    "ik_newton": ("ik_newton.cu", (), {
        "omg_ik_prefilter": [ctypes.POINTER(ctypes.c_void_p),
                             ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                             ctypes.c_void_p],
        "omg_ik_chain": [ctypes.POINTER(ctypes.c_void_p),
                         ctypes.POINTER(ctypes.c_int)]
        + [ctypes.c_float] * 4 + [ctypes.c_void_p]}),
    "chomp_cost": ("chomp_cost.cu", (), {
        name: [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
               ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
        for name in ("omg_chomp_obstacle", "omg_chomp_step")}),
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


def _raw_stream(dev) -> int:
    """:func:`_stream` without building a ``torch.cuda.Stream``: the
    current stream's handle as an int, read on every call (a graph's
    capture, or a caller's ``torch.cuda.stream``, changes it)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


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
    points [10, P, 3], flat in one float32 buffer on pose_0's device (its
    head is :func:`_ik_tables`)."""
    dev = pose_0.device
    return torch.cat([
        _ik_tables(pqr, pose_0),
        _f32_on("center_offset", center_offset, dev,
                (FK_LINKS, 4, 4)).reshape(-1),
        _f32_on("points", points, dev, (FK_LINKS, None, 3)).reshape(-1)])


@functools.lru_cache(maxsize=16)
def _ik_tables(pqr, pose_0) -> Tensor:
    """The head of :func:`_fk_tables`' buffer, which the IK kernels read:
    pqr [7, 3, 4, 4], then pose_0 [10, 4, 4], flat float32 on pose_0's
    device, checked and laid out once per model."""
    dev = pose_0.device
    return torch.cat([
        _f32_on("pqr", pqr, dev, (7, 3, 4, 4)).reshape(-1),
        _f32_on("pose_0", pose_0, dev, (FK_LINKS, 4, 4)).reshape(-1)])


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
    mapped row.

    Inside a CUDA-graph capture it runs out of the graph
    (``utils/graphs.py::outside``), so that each launch is a call of this
    function with arguments of its own: the benchmark's roofline reader
    (``benchmark/probes.py``) counts a launch's work from its call, and on
    a baked volume that work depends on where the points fall."""
    args = (scene, inv_poses, points, epsilons, padding_scales, clearances,
            disables)
    if graphs.capturing():
        return graphs.outside(_THIS, "sdf_query", _sdf_query, args,
                              fresh=(2,))
    return _sdf_query(*args)


def _sdf_query(scene, inv_poses, points, epsilons, padding_scales,
               clearances, disables):
    """:func:`sdf_query`'s launch."""
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


def _rows_vmap(n_out: int, shared: tuple = ()):
    """A vmap rule maker for an operator whose leading dims are scene rows:
    the mapped axis becomes the leading row axis (one launch), an unmapped
    row input is shared by every mapped row, and the inputs at the
    positions of ``shared`` must not be mapped."""
    def make(op):
        def rule(info, in_dims, *args):
            s = info.batch_size
            rows = []
            for i, (a, d) in enumerate(zip(args, in_dims)):
                if not isinstance(a, Tensor) or i in shared:
                    if d is not None:
                        raise ValueError(f"{op} under vmap: argument {i} "
                                         "must be the same for every row")
                    rows.append(a)
                else:
                    rows.append(a.expand(s, *a.shape) if d is None
                                else a.movedim(d, 0))
            return op(*rows), ((0,) * n_out if n_out > 1 else 0)
        return rule
    return make


def _row_count(lead) -> int:
    s = 1
    for n in lead:
        s *= n
    if s >= 2**31:
        raise ValueError("more than 2^31 scene rows")
    return s


# -- md_update ---------------------------------------------------------------

#: the MD learner's experts (``ops/learner.py::NUM_EXPERTS``)
MD_EXPERTS = 5
#: shared memory a block of ``md_update`` may hold (Hopper's 227 KB)
_MAX_SMEM = 232448


def md_update_plain(experts_p, cv, mask, experts_costs, q, live,
                    optim_steps: int, max_iters: int = 20,
                    tol: float = 1e-6, passes: bool = False):
    """Plain version of the ``md_update`` kernel, on the arguments of its
    operator: the MD branch of ``ops/learner.py::update_goal_dist``
    (reference ``online_learner.py:213-235``) on ``experts_p [..., 5,
    G]``, the finalised ``cv [..., G]``, ``mask [..., G]``,
    ``experts_costs [..., 5]``, ``q [..., 5]`` and ``live [...]`` or None
    (leading dims: scene rows; a row that is not live runs no pass of the
    Bregman loop, whose condition is read on the host).  Returns (p,
    experts_p, experts_costs, q), and with ``passes`` each (row, expert)'s
    passes of the loop ``[..., 5]``."""
    from .learner import _ETA_POWERS, NUM_EXPERTS, bregman_projection

    mf = mask.to(cv.dtype)
    n_valid = torch.clamp(mf.sum(-1), min=1.0)
    eta = torch.sqrt(torch.log(n_valid + 1.0) / optim_steps)
    etas = torch.stack([eta * (2.0**x) for x in _ETA_POWERS], dim=-1)
    delta = mf / (4.0 * n_valid[..., None] + 1.0)  # reference :85
    w = torch.ones_like(cv)
    # the experts' projections are independent: one batched projection
    p_new, it = bregman_projection(experts_p,
                                   etas[..., :, None] * cv[..., None, :],
                                   delta, w, mask, max_iters, tol, live=live,
                                   passes=True)
    c_new = ((cv * mf)[..., None, :] * p_new).sum(-1) + (
        (w * mf)[..., None, :] * torch.abs(p_new - experts_p)).sum(-1)
    # only the q recurrence is order-dependent: at inner step i the
    # reference sees fresh costs for experts 0..i and last step's for the
    # rest
    ar = torch.arange(NUM_EXPERTS, device=cv.device)
    for i in range(NUM_EXPERTS):
        costs_i = torch.where(ar <= i, c_new, experts_costs)
        q = q * torch.exp(-costs_i)
        q = q / torch.clamp(torch.sum(q, -1, keepdim=True), min=1e-12)
    p = torch.einsum("...e,...eg->...g", q, p_new)
    p = p / torch.clamp(torch.sum(p, -1, keepdim=True), min=1e-12)
    out = (p * mf, p_new, c_new, q)
    return out + (it,) if passes else out


def _input(name: str, t: Tensor, device, dtype, shape) -> Tensor:
    """``t`` as a kernel reads it, in one pass: of ``dtype``, on ``device``,
    of exactly ``shape``, contiguous (copied only if it is not); raises on
    anything else."""
    if t.dtype != dtype or t.device != device or t.shape != shape:
        _checked(name, t, device, dtype, shape)
    return t if t.is_contiguous() else t.contiguous()


def _md_update_inputs(experts_p, cv, mask, experts_costs, q, live):
    """The kernel's inputs, checked and contiguous: (experts_p, cv, mask,
    experts_costs, q, live or None), the leading (row) dims and G."""
    dev = cv.device
    lead, g = tuple(cv.shape[:-1]), cv.shape[-1]
    e, f32 = MD_EXPERTS, torch.float32
    if g == 0 or 4 * ((2 + 3 * e) * g + 2 * e) > _MAX_SMEM:
        raise ValueError(f"md_update: {g} goals; the kernel takes 1 to "
                         "3,417")
    return (_input("experts_p", experts_p, dev, f32, lead + (e, g)),
            _input("cv", cv, dev, f32, lead + (g,)),
            _input("mask", mask, dev, torch.bool, lead + (g,)),
            _input("experts_costs", experts_costs, dev, f32, lead + (e,)),
            _input("q", q, dev, f32, lead + (e,)),
            None if live is None
            else _input("live", live, dev, torch.bool, lead)), lead, g


def _md_update_outputs(lead, g: int, device):
    """One buffer for the four outputs and its contiguous views (p [...,
    G], experts_p [..., 5, G], experts_costs [..., 5], q [..., 5]), one
    after another as the kernel writes them."""
    s, e = _row_count(lead), MD_EXPERTS
    buf = torch.empty(s * (6 * g + 2 * e), dtype=torch.float32,
                      device=device)
    p, ep, costs, q = buf.unsafe_split_with_sizes((s * g, s * e * g, s * e,
                                                   s * e))
    if lead:
        p, costs, q = (p.view(lead + (g,)), costs.view(lead + (e,)),
                       q.view(lead + (e,)))
    return buf, (p, ep.view(lead + (e, g)), costs, q)


def _md_update_args(ins, buf, lead, g, optim_steps, max_iters):
    """The C entry point's 7 pointers and 4 ints."""
    ptrs = (ctypes.c_void_p * 7)(*[None if t is None else t.data_ptr()
                                   for t in ins], buf.data_ptr())
    return ptrs, (ctypes.c_int * 4)(_row_count(lead), g, optim_steps,
                                    max_iters)


def _md_update_pack(experts_p, cv, mask, experts_costs, q, live,
                    optim_steps, max_iters):
    """Check and lay out the C entry point's arguments: (tensors to keep
    alive, (p, experts_p, experts_costs, q), the 7 pointers, the 4
    ints)."""
    ins, lead, g = _md_update_inputs(experts_p, cv, mask, experts_costs, q,
                                     live)
    buf, outs = _md_update_outputs(lead, g, cv.device)
    ptrs, dims = _md_update_args(ins, buf, lead, g, optim_steps, max_iters)
    return ins, outs, ptrs, dims


def _md_update_cuda(experts_p, cv, mask, experts_costs, q, live,
                    optim_steps, max_iters, tol):
    keep, outs, ptrs, dims = _md_update_pack(
        experts_p, cv, mask, experts_costs, q, live, optim_steps, max_iters)
    if dims[0] == 0:
        return outs
    status = _entry("md_update", "omg_md_update")(ptrs, dims, tol,
                                                  _raw_stream(cv.device))
    del keep  # the stream orders any reuse of these blocks after the launch
    if status != 0:
        raise RuntimeError(f"md_update launch failed: CUDA error {status}")
    md_update.launches += 1
    return outs


_md_update_op = _define(
    "md_update(Tensor experts_p, Tensor cv, Tensor mask, "
    "Tensor experts_costs, Tensor q, Tensor? live, int optim_steps, "
    "int max_iters, float tol) -> (Tensor, Tensor, Tensor, Tensor)",
    md_update_plain, _md_update_cuda, _rows_vmap(4))


def md_update(experts_p: Tensor, cv: Tensor, mask: Tensor,
              experts_costs: Tensor, q: Tensor, live, optim_steps: int,
              max_iters: int = 20, tol: float = 1e-6):
    """The MD learner's expert update of :func:`md_update_plain`'s
    arguments (any leading scene dims; ``live`` None: every row): the
    kernel for CUDA tensors (one launch, no host read), the plain version
    for CPU tensors; under ``torch.func.vmap`` one call for every mapped
    row.  Returns (p, experts_p, experts_costs, q)."""
    return _md_update_op(experts_p, cv, mask, experts_costs, q, live,
                         optim_steps, max_iters, tol)


md_update.launches = 0


# -- joint_limit -------------------------------------------------------------

def _limit_violation(xi, lower, upper):
    return (lower - xi) * (xi < lower) + (upper - xi) * (xi > upper)


def _limit_step(ainv, xi, tv):
    """One smoothing pass: ``xi + scale * Ainv @ tv``."""
    tvs = ainv @ tv
    flat_idx = torch.argmax(torch.abs(tv))
    scale = (torch.abs(tv).max()
             / (torch.abs(tvs.reshape(-1)[flat_idx]) + 1e-8))
    return xi + scale * tvs


def limit_loop_trace(xi, lower, upper, ainv, max_steps: int):
    """The plain joint-limit loop on one trajectory ``xi [T, D]`` with
    ``lower``/``upper [D]``, traced: (the violation norms it checks, in
    order, and at each pass the gap between the largest |violation| and
    the next, the argmax's margin).  It ran ``len(norms) - 1`` passes."""
    norms, gaps = [], []
    for _ in range(max_steps + 1):
        tv = _limit_violation(xi, lower, upper)
        norms.append(float(torch.linalg.norm(tv)))
        if norms[-1] <= 1e-2 or len(norms) > max_steps:
            break
        top = torch.topk(tv.abs().reshape(-1), 2).values
        gaps.append(float(top[0] - top[1]))
        xi = _limit_step(ainv, xi, tv)
    return norms, gaps


def joint_limit_plain(xi, lower, upper, ainv, live, max_steps: int):
    """Plain version of the ``joint_limit`` kernel, on the arguments of
    its operator: the smoothed joint-limit projection
    (``omg/optimizer.py:148-164``), which adds ``scale * Ainv @
    violation`` while the violation's norm exceeds 1e-2, at most
    ``max_steps`` times; each check is a host read.  ``xi [T, D]`` with
    ``lower``/``upper [D]`` and no ``live`` is one scene; otherwise
    ``xi [..., T, D]``, ``lower``/``upper [..., D]`` and ``live [...]``
    (None: every row) are scene rows in lockstep, each running while its
    own violation's norm exceeds 1e-2 and only while ``live`` (one host
    read, "any row still running", a pass); a row whose loop has ended
    keeps its trajectory."""
    if xi.ndim == 2 and live is None:
        tv = _limit_violation(xi, lower, upper)
        cnt = 0
        while cnt < max_steps and host_bool(torch.linalg.norm(tv) > 1e-2,
                                            "joint_limit.pass"):
            xi = _limit_step(ainv, xi, tv)
            cnt += 1
            tv = _limit_violation(xi, lower, upper)
        return xi
    vmap = torch.func.vmap
    shape = xi.shape
    xi = xi.reshape(-1, *shape[-2:])
    lo = lower.reshape(-1, 1, shape[-1])
    hi = upper.reshape(-1, 1, shape[-1])
    tv = _limit_violation(xi, lo, hi)

    def over(tv):
        return vmap(torch.linalg.norm)(tv) > 1e-2

    run = over(tv)
    if live is not None:
        run = live.reshape(-1) & run
    cnt = 0
    while cnt < max_steps and host_bool(run.any(), "joint_limit.pass"):
        step = vmap(lambda x, t: _limit_step(ainv, x, t))(xi, tv)
        xi = torch.where(run[:, None, None], step, xi)
        cnt += 1
        tv = _limit_violation(xi, lo, hi)
        run = run & over(tv)
    return xi.reshape(shape)


def _joint_limit_inputs(xi, lower, upper, ainv, live):
    """The kernel's inputs, checked and contiguous: (xi, lower, upper,
    ainv, live or None), the leading (row) dims, T and D."""
    dev = xi.device
    if xi.ndim < 2:
        raise ValueError(f"xi must be [..., T, D], got {tuple(xi.shape)}")
    lead, (t, d) = tuple(xi.shape[:-2]), xi.shape[-2:]
    if 4 * (t * t + 3 * t * d + 2 * d + 196) > _MAX_SMEM:
        raise ValueError(f"joint_limit: T = {t}, D = {d} exceed a block's "
                         "shared memory")
    f32 = torch.float32
    return (_input("xi", xi, dev, f32, lead + (t, d)),
            _input("lower", lower, dev, f32, lead + (d,)),
            _input("upper", upper, dev, f32, lead + (d,)),
            _input("ainv", ainv, dev, f32, (t, t)),
            None if live is None
            else _input("live", live, dev, torch.bool, lead)), lead, t, d


def _joint_limit_args(ins, out, lead, t, d, max_steps):
    """The C entry point's 6 pointers and 4 ints."""
    ptrs = (ctypes.c_void_p * 6)(*[None if a is None else a.data_ptr()
                                   for a in ins], out.data_ptr())
    return ptrs, (ctypes.c_int * 4)(_row_count(lead) if t * d else 0, t, d,
                                    max_steps)


def _joint_limit_pack(xi, lower, upper, ainv, live, max_steps):
    """Check and lay out the C entry point's arguments: (tensors to keep
    alive, the output trajectory, the 6 pointers, the 4 ints)."""
    ins, lead, t, d = _joint_limit_inputs(xi, lower, upper, ainv, live)
    out = torch.empty(lead + (t, d), dtype=torch.float32, device=xi.device)
    ptrs, dims = _joint_limit_args(ins, out, lead, t, d, max_steps)
    return ins, out, ptrs, dims


def _joint_limit_cuda(xi, lower, upper, ainv, live, max_steps):
    keep, out, ptrs, dims = _joint_limit_pack(xi, lower, upper, ainv, live,
                                              max_steps)
    if dims[0] == 0:
        return out
    status = _entry("joint_limit", "omg_joint_limit")(ptrs, dims,
                                                      _raw_stream(xi.device))
    del keep  # the stream orders any reuse of these blocks after the launch
    if status != 0:
        raise RuntimeError(f"joint_limit launch failed: CUDA error {status}")
    joint_limit.launches += 1
    return out


_joint_limit_op = _define(
    "joint_limit(Tensor xi, Tensor lower, Tensor upper, Tensor ainv, "
    "Tensor? live, int max_steps) -> Tensor",
    joint_limit_plain, _joint_limit_cuda, _rows_vmap(1, shared=(3,)))


def joint_limit(xi: Tensor, lower: Tensor, upper: Tensor, ainv: Tensor,
                live=None, max_steps: int = 10) -> Tensor:
    """The smoothed joint-limit projection of :func:`joint_limit_plain`'s
    arguments (``ainv [T, T]``: ``DeviceHorizon.Ainv``): the kernel for
    CUDA tensors (one launch, no host read), the plain version for CPU
    tensors; under ``torch.func.vmap`` one call for every mapped row.
    Returns the trajectory, shaped as ``xi``."""
    return _joint_limit_op(xi, lower, upper, ainv, live, max_steps)


joint_limit.launches = 0

# -- the goal-set build's IK: ik_prefilter and ik_chain -----------------------

def ik_error_and_jac(pqr, pose_0, q7, targets):
    """Twist errors and Jacobians of the hand for a batch on the model's
    tables: q7 [B, 7], targets [B, 4, 4] -> (e [B, 6], jac [B, 6, 7]).
    The per-lane body that both IK kernels run."""
    b = q7.shape[0]
    q9 = torch.cat([q7, q7.new_full((b, 2), 0.04)], dim=1)
    poses, origins, axes = panda.fk_batch_tables(pqr, pose_0, None, q9, True,
                                                 False)
    hand = poses[:, 7]
    p = hand[:, :3, 3]
    e_pos = targets[:, :3, 3] - p
    r_err = torch.einsum("bij,bkj->bik", targets[:, :3, :3], hand[:, :3, :3])
    e = torch.cat([e_pos, so3_log(r_err)], dim=1)
    lin = torch.linalg.cross(axes[:, :7], p[:, None, :] - origins[:, :7],
                             dim=-1)                            # [B,7,3]
    jac = torch.cat([lin, axes[:, :7]], dim=-1)                 # [B,7,6]
    return e, jac.transpose(1, 2)


def ik_newton_step(jac, e, q, lam, lower7, upper7):
    """One damped Newton step, clamped to +-0.5 rad and to the limits."""
    eye6 = torch.eye(6, dtype=q.dtype, device=q.device)
    jjt = torch.einsum("bij,bkj->bik", jac, jac) + lam * eye6
    dq = torch.einsum("bij,bi->bj", jac, solve_spd_unrolled(jjt, e))
    return torch.minimum(torch.maximum(q + torch.clamp(dq, -0.5, 0.5),
                                       lower7), upper7)


def ik_prefilter_plain(targets, seeds, pqr, pose_0, lower7, upper7,
                       damping: float, iters: int):
    """Plain version of the ``ik_prefilter`` kernel, on the arguments of its
    operator: ``iters`` damped Newton steps from ``seeds [..., 7]`` towards
    ``targets [..., 4, 4]`` (the leading dims are lanes), then the twist
    error.  Returns (q [..., 7], twist norm [...])."""
    lead = seeds.shape[:-1]
    tgt, q = targets.reshape(-1, 4, 4), seeds.reshape(-1, 7)
    for _ in range(iters):
        e, jac = ik_error_and_jac(pqr, pose_0, q, tgt)
        q = ik_newton_step(jac, e, q, damping, lower7, upper7)
    e, _ = ik_error_and_jac(pqr, pose_0, q, tgt)
    if iters == 0:
        q = q.clone()      # an operator returns no alias of its input
    return q.reshape(lead + (7,)), torch.linalg.norm(e, dim=1).reshape(lead)


def ik_chain_plain(chain_tgts, seeds, active, budgets, pqr, pose_0, lower7,
                   upper7, damping: float, pos_tol: float, rot_tol: float,
                   max_iters: int, stall_window: int, passes: bool = False):
    """Plain version of the ``ik_chain`` kernel, on the arguments of its
    operator: the whole standoff chain of each lane (``chain_tgts [...,
    K, 4, 4]``, far standoff first; the leading dims are lanes) as one
    loop with per-lane stage advance.  When a lane's stage converges
    (twist norm <= ``pos_tol``), exhausts ``max_iters`` or stalls (no 15%
    gain in ``stall_window`` iterations) it records q, is graded by the
    10x-loose acceptance on the ``so3_log`` norm and re-targets the next
    stage from the same q; a failed stage ends the lane.  Lanes not
    ``active`` start done.  ``budgets [...]`` int32 caps the iterations
    that a lane may run, counted globally (0: no cap); a lane stopped by
    it is not ok; an int is every lane's budget.  The loop reads "any
    lane live" on the host once a pass.  Returns (qs [..., K-1, 7] tail
    solutions, ok [...]), and with ``passes`` each lane's twist
    evaluations and Newton steps [...]."""
    lead, k = seeds.shape[:-1], chain_tgts.shape[-3]
    chain_tgts = chain_tgts.reshape(-1, k, 4, 4)
    q = seeds.reshape(-1, 7)
    b, dev = q.shape[0], q.device
    active = active.reshape(-1)
    budgets = (budgets.reshape(-1) if torch.is_tensor(budgets)
               else torch.full((b,), budgets, dtype=torch.int32, device=dev))
    lanes = torch.arange(b, device=dev)
    s = torch.where(active, 0, k)                # inactive lanes: done
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    err_best = torch.full((b,), torch.inf, device=dev)
    stall = torch.zeros(b, dtype=torch.int32, device=dev)
    ok = active
    qs = torch.zeros((b, k, 7), dtype=q.dtype, device=dev)
    uncapped = budgets == 0
    evals = torch.zeros(b, dtype=torch.int32, device=dev)
    steps = torch.zeros(b, dtype=torch.int32, device=dev)
    glob = 0
    live = s < k
    while host_bool(torch.any(live), "ik.chain"):
        if passes:
            evals += live
        stage = torch.clamp(s, max=k - 1)
        tgt_now = chain_tgts[lanes, stage]
        e, jac = ik_error_and_jac(pqr, pose_0, q, tgt_now)
        err = torch.linalg.norm(e, dim=1)

        stalled = ((stall >= stall_window) if stall_window
                   else torch.zeros_like(live))
        fin = live & ((err <= pos_tol) | (it >= max_iters) | stalled)
        pos_err = torch.linalg.norm(e[:, :3], dim=1)
        rot_err = torch.linalg.norm(e[:, 3:], dim=1)
        succ = (pos_err < pos_tol * 10) & (rot_err < rot_tol * 10)

        rec = (fin[:, None]
               & (torch.arange(k, device=dev)[None, :] == stage[:, None]))
        qs = torch.where(rec[:, :, None], q[:, None, :], qs)
        ok = ok & torch.where(fin, succ, torch.ones_like(succ))
        s = torch.where(fin, torch.where(succ, s + 1, k), s)

        q_new = ik_newton_step(jac, e, q, damping, lower7, upper7)
        upd = live & ~fin
        if passes:
            steps += upd
        improved = err < 0.85 * err_best
        q = torch.where(upd[:, None], q_new, q)
        it = torch.where(fin, 0, it + upd.to(it.dtype))
        err_best = torch.where(fin, torch.full_like(err, torch.inf),
                               torch.minimum(err_best, err))
        stall = torch.where(fin | improved, 0, stall + upd.to(stall.dtype))
        glob += 1
        live = (s < k) & (uncapped | (glob < budgets))
    # budget-capped lanes never completed every stage: not valid
    ok = ok & (s >= k)
    out = qs[:, 1:].reshape(lead + (k - 1, 7)), ok.reshape(lead)
    return out + (evals.reshape(lead), steps.reshape(lead)) if passes else out


def ik_acceptance(chain_tgts, qs, pqr, pose_0):
    """What the chain's acceptance compares at each recorded tail solution
    ``qs [B, K-1, 7]`` against its stage's pose (``chain_tgts [B, K, 4,
    4]``, far standoff first): (position error, ``so3_log`` norm), each [B,
    K-1]; a stage is accepted below 10 x ``ik_pos_tol`` and 10 x
    ``ik_rot_tol``."""
    b, k = chain_tgts.shape[:2]
    e, _ = ik_error_and_jac(pqr, pose_0, qs.reshape(-1, 7),
                            chain_tgts[:, 1:].reshape(-1, 4, 4))
    return (torch.linalg.norm(e[:, :3], dim=1).reshape(b, k - 1),
            torch.linalg.norm(e[:, 3:], dim=1).reshape(b, k - 1))


def _ik_shared(pqr, pose_0, lower7, upper7, dev) -> list:
    """The model's tables and the limits as the kernels read them."""
    tables = _ik_tables(pqr, pose_0)
    if tables.device != dev:
        raise ValueError(f"the model's tables are on {tables.device}, "
                         f"expected {dev}")
    return [tables, _input("lower7", lower7, dev, torch.float32, (7,)),
            _input("upper7", upper7, dev, torch.float32, (7,))]


def _pose_lanes(name: str, t: Tensor, device, lead) -> tuple:
    """``t [*lead, 4, 4]`` as the prefilter reads it: (float32 [n, 4, 4]
    whose 4 x 4s are each contiguous and lie one stride apart, that stride
    in floats).  A view of that form, such as one stage of the standoff
    targets, is read in place; anything else is copied once."""
    if t.dtype != torch.float32 or t.device != device or t.shape != (
            lead + (4, 4)):
        _checked(name, t, device, torch.float32, lead + (4, 4))
    if t.ndim == 3 and t.stride()[1:] == (4, 1) and t.stride(0) < 2**31:
        return t, t.stride(0)
    try:
        lanes = t.view(-1, 4, 4)
    except RuntimeError:     # its lanes lie at more than one stride
        lanes = t.reshape(-1, 4, 4)
    if lanes.stride()[1:] != (4, 1) or lanes.stride(0) >= 2**31:
        lanes = lanes.contiguous()
    return lanes, lanes.stride(0)


def _ik_prefilter_pack(targets, seeds, pqr, pose_0, lower7, upper7, iters):
    """Check and lay out the C entry point's arguments: (tensors to keep
    alive, (q, err), the 7 pointers, the 3 ints)."""
    dev = seeds.device
    lead = tuple(seeds.shape[:-1])
    f32 = torch.float32
    tgt, stride = _pose_lanes("targets", targets, dev, lead)
    ins = [tgt, _input("seeds", seeds, dev, f32, lead + (7,))]
    ins += _ik_shared(pqr, pose_0, lower7, upper7, dev)
    n = _row_count(lead)
    buf = torch.empty(n * 8, dtype=f32, device=dev)
    q, err = buf.unsafe_split_with_sizes((n * 7, n))
    outs = (q.view(lead + (7,)), err.view(lead))
    ptrs = (ctypes.c_void_p * 7)(*[t.data_ptr() for t in ins],
                                 q.data_ptr(), err.data_ptr())
    return ins, outs, ptrs, (ctypes.c_int * 3)(n, iters, stride)


def _ik_prefilter_cuda(targets, seeds, pqr, pose_0, lower7, upper7, damping,
                       iters):
    keep, outs, ptrs, dims = _ik_prefilter_pack(targets, seeds, pqr, pose_0,
                                                lower7, upper7, iters)
    if dims[0] == 0:
        return outs
    status = _entry("ik_newton", "omg_ik_prefilter")(
        ptrs, dims, damping, _raw_stream(seeds.device))
    del keep  # the stream orders any reuse of these blocks after the launch
    if status != 0:
        raise RuntimeError(f"ik_prefilter launch failed: CUDA error {status}")
    ik_prefilter.launches += 1
    return outs


_ik_prefilter_op = _define(
    "ik_prefilter(Tensor targets, Tensor seeds, Tensor pqr, Tensor pose_0, "
    "Tensor lower7, Tensor upper7, float damping, int iters) "
    "-> (Tensor, Tensor)",
    ik_prefilter_plain, _ik_prefilter_cuda, _rows_vmap(2, (2, 3, 4, 5)))


def ik_prefilter(targets: Tensor, seeds: Tensor, pose_0: Tensor,
                 chain_post: Tensor, lower7: Tensor, upper7: Tensor,
                 damping: float, iters: int):
    """The two-stage goal-set solve's prefilter (:func:`ik_prefilter_plain`
    on a ``PandaModel``'s ``pose_0`` and ``chain_post``): the kernel for
    CUDA tensors (one launch, one warp a lane; ``targets`` may be a view
    whose lanes lie one stride apart, read in place), the plain version
    for CPU tensors.  Returns (q [..., 7], twist norm [...])."""
    return _ik_prefilter_op(targets, seeds,
                            panda.pqr_table(pose_0, chain_post), pose_0,
                            lower7, upper7, damping, iters)


ik_prefilter.launches = 0


def _ik_chain_pack(chain_tgts, seeds, active, budgets, pqr, pose_0, lower7,
                   upper7, max_iters, stall_window):
    """Check and lay out the C entry point's arguments: (tensors to keep
    alive, (qs, ok), the 9 pointers, the 5 ints).  ``budgets`` is a
    tensor of each lane's or an int, every lane's (passed as the fifth
    int, with no budgets pointer)."""
    dev = seeds.device
    lead = tuple(seeds.shape[:-1])
    k = chain_tgts.shape[-3] if chain_tgts.ndim >= 3 else 0
    if k < 1:
        raise ValueError("ik_chain: chain_tgts must be [..., K, 4, 4] with "
                         f"K >= 1, got {tuple(chain_tgts.shape)}")
    f32 = torch.float32
    per_lane = torch.is_tensor(budgets)
    ins = [_input("chain_tgts", chain_tgts, dev, f32, lead + (k, 4, 4)),
           _input("seeds", seeds, dev, f32, lead + (7,)),
           _input("active", active, dev, torch.bool, lead),
           _input("budgets", budgets, dev, torch.int32, lead)
           if per_lane else None]
    ins += _ik_shared(pqr, pose_0, lower7, upper7, dev)
    n = _row_count(lead)
    qs = torch.empty(lead + (k - 1, 7), dtype=f32, device=dev)
    ok = torch.empty(lead, dtype=torch.bool, device=dev)
    ptrs = (ctypes.c_void_p * 9)(*[None if t is None else t.data_ptr()
                                   for t in ins], qs.data_ptr(),
                                 ok.data_ptr())
    return ins, (qs, ok), ptrs, (ctypes.c_int * 5)(
        n, k, max_iters, stall_window, 0 if per_lane else budgets)


def _ik_chain_cpu(chain_tgts, seeds, active, budgets, pqr, pose_0, lower7,
                  upper7, damping, pos_tol, rot_tol, max_iters, stall_window,
                  budget):
    return ik_chain_plain(chain_tgts, seeds, active,
                          budget if budgets is None else budgets, pqr,
                          pose_0, lower7, upper7, damping, pos_tol, rot_tol,
                          max_iters, stall_window)


def _ik_chain_cuda(chain_tgts, seeds, active, budgets, pqr, pose_0, lower7,
                   upper7, damping, pos_tol, rot_tol, max_iters,
                   stall_window, budget):
    keep, outs, ptrs, dims = _ik_chain_pack(
        chain_tgts, seeds, active, budget if budgets is None else budgets,
        pqr, pose_0, lower7, upper7, max_iters, stall_window)
    if dims[0] == 0:
        return outs
    status = _entry("ik_newton", "omg_ik_chain")(
        ptrs, dims, damping, pos_tol, pos_tol * 10, rot_tol * 10,
        _raw_stream(seeds.device))
    del keep  # the stream orders any reuse of these blocks after the launch
    if status != 0:
        raise RuntimeError(f"ik_chain launch failed: CUDA error {status}")
    ik_chain.launches += 1
    return outs


_ik_chain_op = _define(
    "ik_chain(Tensor chain_tgts, Tensor seeds, Tensor active, "
    "Tensor? budgets, Tensor pqr, Tensor pose_0, Tensor lower7, "
    "Tensor upper7, float damping, float pos_tol, float rot_tol, "
    "int max_iters, int stall_window, int budget) -> (Tensor, Tensor)",
    _ik_chain_cpu, _ik_chain_cuda, _rows_vmap(2, (4, 5, 6, 7)))


def ik_chain(chain_tgts: Tensor, seeds: Tensor, active: Tensor,
             budgets: Tensor | int, pose_0: Tensor, chain_post: Tensor,
             lower7: Tensor, upper7: Tensor, damping: float, pos_tol: float,
             rot_tol: float, max_iters: int, stall_window: int):
    """The fused standoff chain (:func:`ik_chain_plain` on a
    ``PandaModel``'s ``pose_0`` and ``chain_post``): the kernel for CUDA
    tensors (one launch, one warp a lane, no host read), the plain version
    for CPU tensors.  ``budgets`` is each lane's (a tensor) or one for
    every lane (an int, which reaches the kernel as an argument and makes
    no tensor).  Returns (qs [..., K-1, 7], ok [...])."""
    per_lane = torch.is_tensor(budgets)
    return _ik_chain_op(chain_tgts, seeds, active,
                        budgets if per_lane else None,
                        panda.pqr_table(pose_0, chain_post), pose_0, lower7,
                        upper7, damping, pos_tol, rot_tol, max_iters,
                        stall_window, 0 if per_lane else budgets)


ik_chain.launches = 0

# -- the CHOMP step: chomp_obstacle and chomp_step ---------------------------

#: the most dofs ``chomp_obstacle``'s kernel takes (a lane's partial sums)
CHOMP_MAX_DOF = 16
#: ``CostInfo``'s scalar fields in the order ``chomp_step`` packs them (its
#: float output is these, then ``cost_traj [T]``; its flags are terminate,
#: failure_terminate, execute and violate_limit)
INFO_SCALARS = ("cost", "obs", "smooth", "weighted_obs", "weighted_smooth",
                "grad_norm", "smooth_grad_norm", "obs_grad_norm", "collide",
                "reach")


def _plain_rows(fn, rows, ndims, shared, lead):
    """``fn(*row, *shared)`` on each scene row of ``rows`` (leading dims
    ``lead``; ``ndims`` each argument's dims in a row, an argument without
    the leading dims shared by every row); its outputs stacked."""
    s = _row_count(lead)
    if s == 0:
        raise ValueError("no scene rows")
    flat = [a.expand(lead + a.shape[a.ndim - d:]).reshape(
        (s,) + a.shape[a.ndim - d:]) for a, d in zip(rows, ndims)]
    outs = [fn(*(a[r] for a in flat), *shared) for r in range(s)]
    return tuple(torch.stack(o).reshape(lead + o[0].shape)
                 for o in zip(*outs))


def _jacobian_parts(tables, n_links: int):
    """(joint row of each dof [D] int64, prismatic [D], affect [L, D],
    finger links [L]) of ``models/api.py::jacobian_tables``' buffer."""
    d = (tables.shape[0] - n_links) // (n_links + 2)
    if 2 * d + n_links * d + n_links != tables.shape[0] or d <= 0:
        raise ValueError(f"the Jacobian tables ({tables.shape[0]} values) "
                         f"do not fit {n_links} links")
    rows, prismatic, affect, finger = tables.split(
        (d, d, n_links * d, n_links))
    return rows.long(), prismatic, affect.reshape(n_links, d), finger


def obstacle_point_terms(x, origins, axes, x_start, x_end, pot, grad,
                         collide, dmats, tables, dt: float, soften: bool):
    """The per-point terms of the plain ``chomp_obstacle`` for one row:
    the finger softening (``soften``: ``omg/cost.py:350-353``), the point
    Jacobians, the endpoint-corrected velocity and acceleration.  Returns
    (v, a_ws [T, L, P, 3], jac [T, L, P, D, 3], pot, grad, collide
    count)."""
    dof_rows, prismatic, affect, finger = _jacobian_parts(tables,
                                                          pot.shape[1])
    if soften:
        scale = 1.0 - 0.9 * finger
        pot = pot * scale[None, :, None]
        grad = grad * scale[None, :, None, None]
        collide = collide * (1.0 - finger)[None, :, None]
    jac = panda.point_jacobians_tables(origins, axes, x, dof_rows,
                                       prismatic, affect)
    xs = torch.movedim(x, 0, 2)  # [L, P, T, 3]
    v = derivative(dmats, dt, xs, x_start, x_end, 1)
    a_ws = derivative(dmats, dt, xs, x_start, x_end, 2)
    return (torch.movedim(v, 2, 0), torch.movedim(a_ws, 2, 0), jac, pot,
            grad, collide.sum())


def functional_grad_terms(v, a_ws, pot, grad):
    """CHOMP workspace functional gradient terms (``omg/cost.py:24-43``)::

        cost = pot * |v|
        dir  = |v| P g - pot P a / |v|^2,   P = I - v_hat v_hat^T
    """
    vel_norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    cost = pot * vel_norm[..., 0]
    v_hat = v / (vel_norm + 1e-8)

    def proj(w):
        return w - v_hat * torch.sum(v_hat * w, dim=-1, keepdim=True)

    curv = pot[..., None] * proj(a_ws) / (vel_norm**2 + 1e-8)
    direction = vel_norm * proj(grad) - curv
    return cost, direction


def obstacle_selection(pot, tables, k: int, consider_finger: bool):
    """The plain ``chomp_obstacle``'s selection of the (softened)
    potentials ``pot [T, L, P]``: (the k-th largest potential, or None
    when every point takes part (``k`` 0 or at least T L P), the mask [T,
    L, P] of the points at or above it, the finger links dropped unless
    ``consider_finger``)."""
    t_dim, n_links, p = pot.shape
    total = t_dim * n_links * p
    kth = None
    if k and k < total:
        kth = top_k(pot.reshape(-1), k)[0][-1]
        sel = (pot >= kth).to(pot.dtype)
    else:
        sel = torch.ones_like(pot)

    if not consider_finger and k:
        # finger links are excluded in the top-k branch (omg/cost.py:401-402)
        link_mask = 1.0 - _jacobian_parts(tables, n_links)[3]
        sel = sel * link_mask[None, :, None]
    return kth, sel


def chomp_obstacle_plain(x, origins, axes, x_start, x_end, pot, grad,
                         collide, dmats, tables, dt: float, k: int,
                         consider_finger: bool, soften: bool, quirks: bool):
    """Plain version of the ``chomp_obstacle`` kernel, on the arguments of
    its operator: the obstacle loss and its configuration-space gradient
    (``omg/cost.py:362-423``) of a trajectory's body points ``x [T, L, P,
    3]`` with its joints' world ``origins``/``axes [T, J, 3]``, the start's
    and end's body points ``x_start``/``x_end [L, P, 3]`` and the query's
    ``pot``/``collide [T, L, P]`` and ``grad [T, L, P, 3]``; ``dmats [3, T
    + 1, T]`` and ``dt`` the horizon's difference matrices and time
    interval, ``tables`` the model's (``models/api.py::jacobian_tables``).
    Top-k sparsified as a mask: points at or above the ``k``-th largest
    potential contribute (every point when ``k`` is 0 or at least T L P),
    the finger links only with ``consider_finger``; ``quirks`` takes the
    reference's (one gradient point per (t, link), the per-link cost
    broadcast over t).  Leading dims are scene rows.  Returns (obs_cost
    [T, L], obs_grad [T, D], collide count [])."""
    if pot.ndim > 3:
        return _plain_rows(
            chomp_obstacle_plain,
            (x, origins, axes, x_start, x_end, pot, grad, collide),
            (4, 3, 3, 3, 3, 3, 4, 3),
            (dmats, tables, dt, k, consider_finger, soften, quirks),
            pot.shape[:-3])
    v, a_ws, jac, pot, grad, collide = obstacle_point_terms(
        x, origins, axes, x_start, x_end, pot, grad, collide, dmats, tables,
        dt, soften)
    p = pot.shape[-1]
    cost_pt, direction = functional_grad_terms(v, a_ws, pot, grad)
    sel = obstacle_selection(pot, tables, k, consider_finger)[1]

    if quirks and k:
        # the reference's top-k quirks (omg/cost.py:404-421): one gradient
        # point per (timestep, link), per-link cost broadcast over time
        score = torch.where(sel > 0, pot, torch.full_like(pot, -torch.inf))
        best = torch.argmax(score, dim=-1)
        onehot = torch.nn.functional.one_hot(best, p).to(pot.dtype)
        any_sel = (sel.sum(-1, keepdim=True) > 0).to(pot.dtype)
        gsel = onehot * any_sel
        obs_cost = (cost_pt * sel).sum((0, -1))[None, :].expand(
            cost_pt.shape[:2])
        obs_grad = torch.einsum("tjpdc,tjpc->td", jac,
                                direction * gsel[..., None])
        return obs_cost, obs_grad, collide

    obs_cost = (cost_pt * sel).sum(-1)  # [T, 10]
    obs_grad = torch.einsum("tjpdc,tjpc->td", jac, direction * sel[..., None])
    return obs_cost, obs_grad, collide


def chomp_obstacle_threads(t: int, n_links: int, p: int) -> int:
    """Threads a block of the ``chomp_obstacle`` kernel takes (one block a
    row; ``chomp_cost.cu::chomp_obstacle_threads``): 1,024, or the row's
    points in whole warps where they are fewer."""
    return min(1024, (t * n_links * p + 31) // 32 * 32)


def _chomp_obstacle_smem(t: int, n_links: int, p: int, d: int) -> int:
    """Bytes of shared memory a block of the kernel takes
    (``chomp_cost.cu::chomp_obstacle_smem``): the potentials, the selected
    costs and the list of selected points (3 words a point), a round's
    contributions (D a thread, or D a (t, link) under the quirks), the
    gradient's sums, the dof frames and the tables, the band, the select's
    bins.  Where 6 words a point more fit a block, the kernel also copies
    the positions and gradients in."""
    n = t * n_links * p
    nc = max(chomp_obstacle_threads(t, n_links, p), t * n_links)
    return 4 * (3 * n + nc * d + t * d + 6 * t * d + n_links * d + d
                + n_links + t * n_links + 32 + 2 * t * 8 + (t + 1) + 32
                + 256 + 2 + 1)


def _chomp_obstacle_pack(x, origins, axes, x_start, x_end, pot, grad,
                         collide, dmats, tables, dt, k, consider_finger,
                         soften, quirks, selection: bool = False):
    """Check and lay out the C entry point's arguments: (tensors to keep
    alive, (obs_cost, obs_grad, collide), the 15 pointers, the 9 ints, the
    4 floats).  With ``selection`` (a check of the kernel, never the
    operator) the outputs also hold the k-th largest potential [...] (NaN
    where every point takes part) and the selection mask [..., T, L, P]
    that the kernel writes."""
    dev = pot.device
    if pot.ndim < 3:
        raise ValueError(f"pot must be [..., T, L, P], got "
                         f"{tuple(pot.shape)}")
    lead, (t, n_links, p) = tuple(pot.shape[:-3]), tuple(pot.shape[-3:])
    f32 = torch.float32
    if origins.ndim < 2:
        raise ValueError("origins must be [..., T, J, 3]")
    j = origins.shape[-2]
    d = (tables.shape[0] - n_links) // (n_links + 2) if tables.ndim else 0
    if (tables.ndim != 1 or 2 * d + n_links * d + n_links != tables.shape[0]
            or not 0 < d <= CHOMP_MAX_DOF):
        raise ValueError(f"chomp_obstacle: tables of {tuple(tables.shape)} "
                         f"do not fit {n_links} links and 1 to "
                         f"{CHOMP_MAX_DOF} dofs")
    if _chomp_obstacle_smem(t, n_links, p, d) > _MAX_SMEM:
        raise ValueError(f"chomp_obstacle: T L P = {t * n_links * p} points "
                         "exceed a block's shared memory")
    if dmats.ndim != 3 or dmats.shape[0] < 2:
        raise ValueError("dmats must be [>= 2, T + 1, T]")
    ins = (_input("x", x, dev, f32, lead + (t, n_links, p, 3)),
           _input("origins", origins, dev, f32, lead + (t, j, 3)),
           _input("axes", axes, dev, f32, lead + (t, j, 3)),
           _input("x_start", x_start, dev, f32, lead + (n_links, p, 3)),
           _input("x_end", x_end, dev, f32, lead + (n_links, p, 3)),
           _input("pot", pot, dev, f32, lead + (t, n_links, p)),
           _input("grad", grad, dev, f32, lead + (t, n_links, p, 3)),
           _input("collide", collide, dev, f32, lead + (t, n_links, p)),
           _input("dmats", dmats, dev, f32, (dmats.shape[0], t + 1, t)),
           _input("tables", tables, dev, f32, tables.shape))
    s = _row_count(lead)
    buf = torch.empty(s * (t * n_links + t * d + 1), dtype=f32, device=dev)
    oc, og, cs = buf.unsafe_split_with_sizes((s * t * n_links, s * t * d, s))
    outs = (oc.view(lead + (t, n_links)), og.view(lead + (t, d)),
            cs.view(lead))
    extra = [None, None]
    if selection:
        outs += (torch.empty(lead, dtype=f32, device=dev),
                 torch.empty(lead + (t, n_links, p), dtype=f32, device=dev))
        extra = [outs[3].data_ptr(), outs[4].data_ptr()]
    ptrs = (ctypes.c_void_p * 15)(*[a.data_ptr() for a in ins],
                                  oc.data_ptr(), og.data_ptr(), cs.data_ptr(),
                                  *extra)
    mid = DIFF_RULE_LENGTH // 2
    flags = int(soften) | 2 * int(consider_finger) | 4 * int(quirks)
    dims = (ctypes.c_int * 9)(s if t else 0, t, n_links, p, j, d, k, mid,
                              flags)
    consts = (ctypes.c_float * 4)(
        DIFF_RULES[0][mid - 1] / dt, DIFF_RULES[0][mid + 1] / dt,
        DIFF_RULES[1][mid - 1] / dt ** 2, DIFF_RULES[1][mid + 1] / dt ** 2)
    return ins, outs, ptrs, dims, consts


def _chomp_obstacle_cuda(*args):
    keep, outs, ptrs, dims, consts = _chomp_obstacle_pack(*args)
    if dims[0] == 0:
        return outs
    status = _entry("chomp_cost", "omg_chomp_obstacle")(
        ptrs, dims, consts, _raw_stream(outs[0].device))
    del keep  # the stream orders any reuse of these blocks after the launch
    if status != 0:
        raise RuntimeError(f"chomp_obstacle launch failed: CUDA error "
                           f"{status}")
    chomp_obstacle.launches += 1
    return outs


_chomp_obstacle_op = _define(
    "chomp_obstacle(Tensor x, Tensor origins, Tensor axes, Tensor x_start, "
    "Tensor x_end, Tensor pot, Tensor grad, Tensor collide, Tensor dmats, "
    "Tensor tables, float dt, int k, bool consider_finger, bool soften, "
    "bool quirks) -> (Tensor, Tensor, Tensor)",
    chomp_obstacle_plain, _chomp_obstacle_cuda, _rows_vmap(3, (8, 9)))


def chomp_obstacle(x: Tensor, origins: Tensor, axes: Tensor,
                   x_start: Tensor, x_end: Tensor, pot: Tensor, grad: Tensor,
                   collide: Tensor, dmats: Tensor, tables: Tensor, dt: float,
                   k: int, consider_finger: bool, soften: bool,
                   quirks: bool):
    """The obstacle loss and gradient of :func:`chomp_obstacle_plain`'s
    arguments (any leading scene dims): the kernel for CUDA tensors (one
    launch, one block a row), the plain version for CPU tensors; under
    ``torch.func.vmap`` one call for every mapped row (the difference
    matrices and the tables shared).  Returns (obs_cost [..., T, L],
    obs_grad [..., T, D], collide count [...]).  Inside a CUDA-graph
    capture it runs out of the graph, as :func:`sdf_query` does."""
    args = (x, origins, axes, x_start, x_end, pot, grad, collide, dmats,
            tables, dt, k, consider_finger, soften, quirks)
    if graphs.capturing():
        return graphs.outside(_THIS, "chomp_obstacle", _chomp_obstacle_op,
                              args)
    return _chomp_obstacle_op(*args)


chomp_obstacle.launches = 0


def smooth_terms(d1, a, dt: float, xi, start, end, goal_set_proj: bool):
    """Finite-difference velocity-norm smoothness (``omg/cost.py:425-449``)
    of ``xi [T, D]`` on the horizon's ``d1 [T + 1, T]``, ``A [T, T]`` and
    time interval; under ``goal_set_proj`` the end row is free.  Returns
    (loss [T+1], grad [T, D])."""
    mid = DIFF_RULE_LENGTH // 2
    # built out of place, so torch.func.vmap can batch it over scenes
    first = float(DIFF_RULES[0][mid - 1]) * start / dt
    last = (torch.zeros_like(end) if goal_set_proj
            else float(DIFF_RULES[0][mid]) * end / dt)
    ed = torch.cat([first[None], xi.new_zeros((xi.shape[0] - 1,
                                               xi.shape[1])), last[None]])
    velocity = d1 @ xi
    vel_norm = torch.linalg.norm(velocity + ed, dim=1)
    loss = 0.5 * vel_norm**2
    grad = a @ xi + d1.T @ ed
    return loss, grad


def loss_terms(s_loss, s_grad, o_cost, o_grad, collide, xi, goal,
               obstacle_w, smooth_w, clip: float, allow: float,
               terminate_smooth: float, goal_set_proj: bool,
               pre_terminate: bool):
    """The total cost, gradient and diagnostics (``omg/cost.py:451-532``)
    from the smoothness and obstacle terms.  Returns (grad [T, D], the
    packed floats [10 + T] (:data:`INFO_SCALARS`, then ``cost_traj``),
    (terminate, failure_terminate, execute))."""
    s_sum = s_loss.sum()
    o_sum = o_cost.sum()
    w_obs = obstacle_w * o_sum
    w_smooth = smooth_w * s_sum
    w_obs_grad = torch.clamp(obstacle_w * o_grad, -clip, clip)
    w_smooth_grad = smooth_w * s_grad
    cost = w_obs + w_smooth
    grad = w_obs_grad + w_smooth_grad
    cost_traj = obstacle_w * o_cost.sum(-1) + smooth_w * s_loss[:-1]

    goal_dist = (torch.linalg.norm(xi[-1] - goal) if goal_set_proj
                 else torch.zeros((), dtype=xi.dtype, device=xi.device))
    if pre_terminate:
        terminate = ((collide <= allow) & (goal_dist < 0.01)
                     & (s_sum < terminate_smooth))
    else:
        terminate = torch.zeros((), dtype=torch.bool, device=xi.device)
    failure = ((collide >= allow * 10)
               | (s_sum >= terminate_smooth * 2.5))
    execute = (collide <= allow) & (s_sum < terminate_smooth)
    floats = torch.stack([
        cost, o_sum, s_sum, w_obs, w_smooth, torch.linalg.norm(grad),
        torch.linalg.norm(w_smooth_grad), torch.linalg.norm(w_obs_grad),
        collide, goal_dist])
    return grad, torch.cat([floats, cost_traj]), (terminate, failure,
                                                  execute)


def limit_violated(xi, lower, upper):
    """Reference ``check_joint_limit`` (``omg/optimizer.py:166-174``) —
    including its quirk of ANDing the low/high masks elementwise."""
    low = (xi < lower - 5e-3).any()
    high = xi > upper + 5e-3
    return (low * high).any()


def projected_update(pmat, mmat, xi, grad, tail, step_size):
    """Projected CHOMP step (``omg/optimizer.py:88-113``):
    ``-step_size P_k grad - M_k (xi[-k:] - tail)``, k = ``tail``'s rows."""
    b = xi[-mmat.shape[1]:] - tail
    return -step_size * (pmat @ grad) - mmat @ b


def dof_update(masks, consider_finger: bool, xi, update):
    """Trajectory update + gripper clamp (``omg/core.py:43-51``) on the
    model's ``masks [2, D]`` (``models/api.py::dof_tables``): only the
    arm dofs move unless ``consider_finger``; the clamped dofs stay in
    [0, 0.04]."""
    if consider_finger:
        xi = xi + update
    else:
        xi = xi + update * masks[0][None, :]
    return torch.where(masks[1] > 0, torch.clamp(xi, 0.0, 0.04), xi)


def chomp_step_plain(xi, start, goal, tail, obs_cost, obs_grad, collide,
                     obstacle_w, smooth_w, step_size, lower, upper, d1, a,
                     pmat, mmat, masks, dt: float, clip: float, allow: float,
                     terminate_smooth: float, goal_set_proj: bool,
                     pre_terminate: bool, consider_finger: bool):
    """Plain version of the ``chomp_step`` kernel, on the arguments of its
    operator: one CHOMP step of ``xi [T, D]`` from ``start``, the chosen
    ``goal [D]`` and its projection tail ``tail [k, D]`` and the obstacle
    terms (``obs_cost [T, L]``, ``obs_grad [T, D]``, ``collide []``):
    smoothness, the weighted total cost and gradient and the termination
    flags (``omg/cost.py:451-532``), the joint-limit check, and the update
    (``omg/optimizer.py:88-135``, ``omg/core.py:43-51``): projected on
    ``pmat`` = P_k and ``mmat`` = M_k under ``goal_set_proj``, else
    ``-step_size pmat grad`` (``pmat`` = Ainv, ``mmat`` unused).  The
    weights are 0-d (or scene rows); leading dims are scene rows.  Returns
    (the updated trajectory before the joint-limit projection, the packed
    floats [10 + T] (:data:`INFO_SCALARS`, then ``cost_traj``), the flags
    [4] (terminate, false where the limits are violated,
    failure_terminate, execute, violate_limit))."""
    if xi.ndim > 2:
        return _plain_rows(
            chomp_step_plain,
            (xi, start, goal, tail, obs_cost, obs_grad, collide, obstacle_w,
             smooth_w, step_size, lower, upper),
            (2, 1, 1, 2, 2, 2, 0, 0, 0, 0, 1, 1),
            (d1, a, pmat, mmat, masks, dt, clip, allow, terminate_smooth,
             goal_set_proj, pre_terminate, consider_finger), xi.shape[:-2])
    s_loss, s_grad = smooth_terms(d1, a, dt, xi, start, goal, goal_set_proj)
    grad, floats, (terminate, failure, execute) = loss_terms(
        s_loss, s_grad, obs_cost, obs_grad, collide, xi, goal, obstacle_w,
        smooth_w, clip, allow, terminate_smooth, goal_set_proj,
        pre_terminate)
    over = limit_violated(xi, lower, upper)
    flags = torch.stack([terminate & ~over, failure, execute, over])
    if goal_set_proj:
        update = projected_update(pmat, mmat, xi, grad, tail, step_size)
    else:
        update = -step_size * (pmat @ grad)
    return dof_update(masks, consider_finger, xi, update), floats, flags


def _chomp_step_weights(lead, dev, weights):
    """The three weights as the kernel reads them: (pointers, constants).
    0-d CPU tensors (the plan loop's schedule) become constants; tensors
    on the card are read a row each."""
    if all(w.device.type == "cpu" and w.ndim == 0 for w in weights):
        return (), [None] * 3, [float(w) for w in weights]
    names = ("obstacle_w", "smooth_w", "step_size")
    ins = tuple(_input(n, w.expand(lead) if w.ndim == 0 else w, dev,
                       torch.float32, lead) for n, w in zip(names, weights))
    return ins, [w.data_ptr() for w in ins], [0.0] * 3


def chomp_step_threads(t: int, d: int) -> int:
    """Threads a block of the ``chomp_step`` kernel takes (one block a row;
    ``chomp_cost.cu::chomp_step_threads``): one a velocity element ((T +
    1) D) in whole warps, at most 1,024."""
    return min(1024, ((t + 1) * d + 31) // 32 * 32)


def _chomp_step_smem(t: int, d: int, n_links: int, k: int) -> int:
    """Bytes of shared memory a block of the ``chomp_step`` kernel takes
    (``chomp_cost.cu::chomp_step_smem``): the row's staged inputs (the
    trajectory, the obstacle terms, six rows of D, the tail, P, M, the
    bands of d1 and A and d1's rows 0 and T), what the block forms and the
    warps' partials."""
    h = DIFF_RULE_LENGTH // 2
    staged = (2 * t * d + t * n_links + 6 * d + k * d + t * t + t * k
              + (t + 1) * 2 * h + 2 * t + t * (4 * h - 1))
    return 4 * (staged + 4 * t * d + d + 2 * t + 1 + 32 * 8)


def _chomp_step_pack(xi, start, goal, tail, obs_cost, obs_grad, collide,
                     obstacle_w, smooth_w, step_size, lower, upper, d1, a,
                     pmat, mmat, masks, dt, clip, allow, terminate_smooth,
                     goal_set_proj, pre_terminate, consider_finger):
    """Check and lay out the C entry point's arguments: (tensors to keep
    alive, (xi, floats, flags), the 20 pointers, the 7 ints, the 10
    floats)."""
    dev = xi.device
    if xi.ndim < 2:
        raise ValueError(f"xi must be [..., T, D], got {tuple(xi.shape)}")
    lead, (t, d) = tuple(xi.shape[:-2]), tuple(xi.shape[-2:])
    if obs_cost.ndim < 2 or tail.ndim < 2:
        raise ValueError("obs_cost must be [..., T, L] and tail [..., k, D]")
    n_links, kt = obs_cost.shape[-1], tail.shape[-2]
    k = mmat.shape[-1] if goal_set_proj and mmat is not None else 0
    if goal_set_proj and (mmat is None or k != kt):
        raise ValueError("chomp_step: goal_set_proj takes M_k [T, k] with "
                         "the tail's k rows")
    if _chomp_step_smem(t, d, n_links, k) > _MAX_SMEM:
        raise ValueError(f"chomp_step: T = {t}, D = {d} exceed a block's "
                         "shared memory")
    f32 = torch.float32
    ins = (_input("xi", xi, dev, f32, lead + (t, d)),
           _input("start", start, dev, f32, lead + (d,)),
           _input("goal", goal, dev, f32, lead + (d,)),
           _input("tail", tail, dev, f32, lead + (kt, d)),
           _input("obs_cost", obs_cost, dev, f32, lead + (t, n_links)),
           _input("obs_grad", obs_grad, dev, f32, lead + (t, d)),
           _input("collide", collide, dev, f32, lead))
    w_ins, w_ptrs, w_consts = _chomp_step_weights(
        lead, dev, (obstacle_w, smooth_w, step_size))
    tabs = (_input("lower", lower, dev, f32, lead + (d,)),
            _input("upper", upper, dev, f32, lead + (d,)),
            _input("d1", d1, dev, f32, (t + 1, t)),
            _input("a", a, dev, f32, (t, t)),
            _input("pmat", pmat, dev, f32, (t, t)),
            None if not k else _input("mmat", mmat, dev, f32, (t, k)),
            _input("masks", masks, dev, f32, (2, d)))
    s = _row_count(lead)
    buf = torch.empty(s * (t * d + 10 + t + 1), dtype=f32, device=dev)
    xo, fo, bo = buf.unsafe_split_with_sizes((s * t * d, s * (10 + t), s))
    outs = (xo.view(lead + (t, d)), fo.view(lead + (10 + t,)),
            bo.view(torch.bool).view(lead + (4,)))
    ptrs = (ctypes.c_void_p * 20)(
        *[x.data_ptr() for x in ins], *w_ptrs,
        *[None if x is None else x.data_ptr() for x in tabs],
        xo.data_ptr(), fo.data_ptr(), bo.data_ptr())
    mid = DIFF_RULE_LENGTH // 2
    flags = (int(goal_set_proj) | 2 * int(pre_terminate)
             | 4 * int(consider_finger))
    dims = (ctypes.c_int * 7)(s if t * d else 0, t, d, n_links, k, mid,
                              flags)
    consts = (ctypes.c_float * 10)(
        DIFF_RULES[0][mid - 1] / dt, DIFF_RULES[0][mid] / dt, clip, allow,
        allow * 10, terminate_smooth, terminate_smooth * 2.5, *w_consts)
    return ins + w_ins + tabs, outs, ptrs, dims, consts


def _chomp_step_cuda(*args):
    keep, outs, ptrs, dims, consts = _chomp_step_pack(*args)
    if dims[0] == 0:
        return outs
    status = _entry("chomp_cost", "omg_chomp_step")(
        ptrs, dims, consts, _raw_stream(outs[0].device))
    del keep  # the stream orders any reuse of these blocks after the launch
    if status != 0:
        raise RuntimeError(f"chomp_step launch failed: CUDA error {status}")
    chomp_step.launches += 1
    return outs


_chomp_step_op = _define(
    "chomp_step(Tensor xi, Tensor start, Tensor goal, Tensor tail, "
    "Tensor obs_cost, Tensor obs_grad, Tensor collide, Tensor obstacle_w, "
    "Tensor smooth_w, Tensor step_size, Tensor lower, Tensor upper, "
    "Tensor d1, Tensor a, Tensor pmat, Tensor? mmat, Tensor masks, "
    "float dt, float clip, float allow, float terminate_smooth, "
    "bool goal_set_proj, bool pre_terminate, bool consider_finger) "
    "-> (Tensor, Tensor, Tensor)",
    chomp_step_plain, _chomp_step_cuda,
    _rows_vmap(3, (12, 13, 14, 15, 16)))


def chomp_step(xi: Tensor, start: Tensor, goal: Tensor, tail: Tensor,
               obs_cost: Tensor, obs_grad: Tensor, collide: Tensor,
               obstacle_w: Tensor, smooth_w: Tensor, step_size: Tensor,
               lower: Tensor, upper: Tensor, d1: Tensor, a: Tensor,
               pmat: Tensor, mmat, masks: Tensor, dt: float, clip: float,
               allow: float, terminate_smooth: float, goal_set_proj: bool,
               pre_terminate: bool, consider_finger: bool):
    """One CHOMP step of :func:`chomp_step_plain`'s arguments (any leading
    scene dims): the kernel for CUDA tensors (one launch, one block a row;
    0-d CPU weights reach it as arguments), the plain version for CPU
    tensors; under ``torch.func.vmap`` one call for every mapped row (the
    horizon's matrices and the model's masks shared).  ``d1`` and ``a``
    are the horizon's (``config.py::get_diff_matrix`` and d1^T d1): the
    kernel reads them only on their bands.  Returns (the updated
    trajectory, the packed floats, the flags)."""
    return _chomp_step_op(xi, start, goal, tail, obs_cost, obs_grad,
                          collide, obstacle_w, smooth_w, step_size, lower,
                          upper, d1, a, pmat, mmat, masks, dt, clip, allow,
                          terminate_smooth, goal_set_proj, pre_terminate,
                          consider_finger)


chomp_step.launches = 0

#: this module, the owner of the wrappers that run out of a CUDA graph
_THIS = sys.modules[__name__]

# every kernel wrapper of the package, for launch accounting
KERNELS = {"min_dist_grid": min_dist_grid, "rigid_rollout": rigid_rollout,
           "panda_fk": panda_fk, "sdf_query": sdf_query,
           "md_update": md_update, "joint_limit": joint_limit,
           "ik_prefilter": ik_prefilter, "ik_chain": ik_chain,
           "chomp_obstacle": chomp_obstacle, "chomp_step": chomp_step}
