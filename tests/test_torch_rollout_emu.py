"""The rollout kernel's own source (``omg_planner_torch/csrc/rigid_rollout.cu``)
compiled with g++ against ``csrc/cuda_emu.h`` and run on the CPU, against
``physics/rigid.py::rollout_plain`` on the same packed arguments.

The emulation runs one fiber per CUDA thread on one host thread, with a
wait for ``__syncthreads``, ``__syncwarp`` and each warp shuffle, so it
executes the kernel's control flow, shared-memory layout, ranks, lane
ownership and warp sums as written; only the card's own instruction
selection (FMA contraction) differs.  Cases, at small width and few
substeps:
* a resting cube on a slab with 144 lanes (8 lanes a thread): world
  contacts, the pseudo pass;
* a batch of two in one launch: a cube pinched by two closing finger pads
  under robot spheres pressing down (pinned pads, patch brakes, robot
  contacts with velocity), and a cube in free fall; then each rollout
  alone, which must give the same bits as its row of the batch.  Every
  pad and world sample may take a lane there: a flat pad face on a flat
  box face ties whole groups of samples, and a top-k cut through such a
  group follows the last bit of the arithmetic;
* the profile build (``-DOMG_ROLLOUT_CYCLES``): the same trace bits and a
  positive count in every phase but the pseudo pass;
* the packer's lane cap.
Bar: 1e-5 on x, v, q, w against the plain loop (float32 in another
summation order), contact counts equal."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from omg_planner_torch.ops import kernels
from omg_planner_torch.physics import rigid as tr

torch.set_num_threads(2)
CSRC = kernels.CSRC


def _compile(out_dir, *defines):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    lib = os.path.join(out_dir, f"librr{'_'.join(('',) + defines)}.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-DOMG_CUDA_EMU", *(f"-D{d}" for d in defines), "-x",
                    "c++", os.path.join(CSRC, "rigid_rollout.cu"), "-o", lib],
                   check=True, capture_output=True)
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rollout_emu"))
    main = _compile(out)
    prof = _compile(out, "OMG_ROLLOUT_CYCLES")
    fns = (main.omg_rigid_rollout, prof.omg_rigid_rollout_cycles)
    for fn in fns:
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _emu(fn, args, kw, cycles=False):
    keep, out_state, out_trace, ptrs, dims = kernels._rigid_rollout_pack(
        *args, kw["k_robot"], kw["k_pad"], kw["k_world"], kw["iters"])
    cyc = None
    if cycles:
        cyc = torch.zeros(dims[0], len(kernels.ROLLOUT_PHASES),
                          dtype=torch.int64)
        ptrs = (ctypes.c_void_p * (len(ptrs) + 1))(*ptrs, cyc.data_ptr())
    assert fn(ptrs, dims, None) == 0
    del keep
    final, traces = kernels._rigid_rollout_unpack(out_state, out_trace)
    return final, traces, cyc


def _world():
    slab = np.eye(4)
    slab[2, 3] = -0.5                     # top face at z = 0
    box = np.eye(4)
    box[:3, 3] = [0.2, 0.0, 0.05]
    return tr.StaticWorld(
        kinds=torch.tensor([0, 0], dtype=torch.int32),
        halfs=torch.tensor([[1.0, 1.0, 0.5], [0.05, 0.05, 0.05]]),
        rounds=torch.tensor([0.0, 0.01]),
        inv_poses=torch.as_tensor(np.stack([np.linalg.inv(slab),
                                            np.linalg.inv(box)]),
                                  dtype=torch.float32),
        mask=torch.ones(2))


def _state(xs):
    b = len(xs)
    return tr.BodyState(x=torch.tensor(xs, dtype=torch.float32),
                        q=torch.tensor([[1.0, 0.0, 0.0, 0.0]] * b),
                        v=torch.zeros(b, 3), w=torch.zeros(b, 3))


def _pinch_inputs(t=12, k=16):
    """Rollout 0: a 3 cm cube on the slab, two pads closing on its +-y
    faces, four robot spheres pressing its top (two of them finger-link
    spheres, excluded); rollout 1: the cube falling from 0.2 m, nothing
    near it."""
    half = 0.03
    spec = tr.body_spec_from_primitive(0, np.full(3, half), n_surf=48,
                                       device="cpu")
    rng = np.random.default_rng(0)
    sph = np.full((2, t + 1, k, 3), 50.0, np.float32)
    top = np.stack([rng.uniform(-0.02, 0.02, 4), rng.uniform(-0.02, 0.02, 4),
                    np.full(4, 2 * half + 0.0055)], -1)
    for s in range(t + 1):                # pressing 0.1 mm a substep
        sph[0, s, :4] = top - [0.0, 0.0, 1e-4 * s]
    is_finger = torch.zeros(k)
    is_finger[2:4] = 1.0
    pads = np.tile(np.eye(4, dtype=np.float32), (2, t + 1, 2, 1, 1))
    for f, sg in enumerate((1.0, -1.0)):
        pads[0, :, f, 1, 3] = sg * (half + 0.0045)
        pads[0, :, f, 2, 3] = half
        pads[1, :, f, :3, 3] = 1e3
    pad_samples = torch.as_tensor(np.stack(
        [tr.box_face_grid([0.012, 0.005, 0.012], 2)] * 2), dtype=torch.float32)
    axis = torch.tensor([[[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]]] * 2)
    jv = np.zeros((2, t + 1, 2), np.float32)
    jv[:, 0] = 0.04                       # open, then commanded shut
    args = (spec, _world(), tr.default_params(device="cpu"),
            _state([[0.0, 0.0, half + 1e-3], [0.0, 0.3, 0.2]]),
            torch.as_tensor(sph), is_finger, torch.as_tensor(pads),
            pad_samples, axis, torch.as_tensor(jv), torch.full((2, 2), 0.04))
    return args, dict(k_robot=8, k_pad=48, k_world=48, iters=24)


def _resting_inputs(t=10):
    spec = tr.body_spec_from_primitive(0, np.full(3, 0.03), device="cpu")
    args, _ = tr._defaults(_state([[0.0, 0.0, 0.031]]),
                           torch.full((1, t + 1, 16, 3), 50.0), None, None,
                           None, None, None, None)
    return ((spec, _world(), tr.default_params(device="cpu")) + args,
            dict(k_robot=16, k_pad=32, k_world=96, iters=24))


def _same(a, b, what):
    (fa, ta), (fb, tb) = a, b
    for k in ("x", "v", "q", "w"):
        err = float((ta[k] - tb[k]).abs().max())
        assert err <= 1e-5, (what, k, err)
    for k in ("robot_contacts", "world_contacts"):
        assert torch.equal(ta[k], tb[k]), (what, k)
    assert float((fa.x - fb.x).abs().max()) <= 1e-5, what


def test_resting_cube_with_eight_lanes_a_thread(libs):
    args, kw = _resting_inputs()
    c = kw["k_robot"] + kw["k_pad"] + kw["k_world"]
    assert 128 < c <= 256
    final, traces, _ = _emu(libs[0], args, kw)
    plain = tr.rollout_plain(*args, **kw)
    _same((final, traces), plain, "resting cube")
    assert float(traces["world_contacts"].max()) > 16


def test_pinch_batch_matches_plain_and_single_launches(libs):
    args, kw = _pinch_inputs()
    final, traces, _ = _emu(libs[0], args, kw)
    plain = tr.rollout_plain(*args, **kw)
    _same((final, traces), plain, "pinch batch")
    # the pads engaged, stalled and were pinned; the robot pressed the top
    assert float(traces["pad_pen_max"][0].max()) >= 3.5e-3
    assert float(traces["jv"][0, -1].max()) > 0.0
    assert float(traces["robot_contacts"][0].max()) > 16
    assert float(traces["world_contacts"][1].max()) == 0.0
    for i in range(2):
        one = tuple(a[i:i + 1] if isinstance(a, torch.Tensor) and j in
                    (4, 6, 8, 9, 10) else a for j, a in enumerate(args))
        one = one[:3] + (tr.BodyState(*(s[i:i + 1] for s in args[3])),) \
            + one[4:]
        f1, t1, _ = _emu(libs[0], one, kw)
        for k in traces:
            assert torch.equal(t1[k][0], traces[k][i]), (i, k)
        assert all(torch.equal(a[0], b[i]) for a, b in zip(f1, final))


def test_profile_build_counts_cycles_and_keeps_the_bits(libs):
    args, kw = _pinch_inputs(t=4)
    _, traces, _ = _emu(libs[0], args, kw)
    _, traces_p, cyc = _emu(libs[1], args, kw, cycles=True)
    for k in traces:
        assert torch.equal(traces[k], traces_p[k]), k
    assert cyc.shape == (2, len(kernels.ROLLOUT_PHASES))
    assert bool((cyc[:, [0, 1, 2, 3, 5]] > 0).all())


def test_pack_refuses_more_lanes_than_the_cap():
    """257 lanes (16 robot, 2 pad, 239 world): the packer raises, naming
    the cap, before any launch; 256 pass."""
    args, _ = _resting_inputs(t=2)
    spec = args[0]._replace(surf=torch.zeros(300, 3))
    assert kernels.MAX_ROLLOUT_LANES == 256
    with pytest.raises(ValueError, match="at most 256"):
        kernels._rigid_rollout_pack(spec, *args[1:], 16, 32, 239, 4)
    dims = kernels._rigid_rollout_pack(spec, *args[1:], 16, 32, 238, 4)[-1]
    assert sum(dims[9:12]) == 256
