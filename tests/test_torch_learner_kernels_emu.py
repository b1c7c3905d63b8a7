"""The plan step's loop kernels' own sources (``omg_planner_torch/csrc/
md_update.cu`` and ``csrc/joint_limit.cu``) compiled with g++ against
``csrc/cuda_emu.h`` and run on the CPU, against their plain versions on
the same inputs.

The emulation runs one fiber per CUDA thread (as
``tests/test_torch_rollout_emu.py`` says), so it executes each kernel's
indexing, warp reductions, barriers and device-side loops as written.
Arguments are packed by the wrappers' own packers
(``ops/kernels.py::_md_update_pack``, ``_joint_limit_pack``) from CPU
tensors.  Cases, at small sizes from numpy seeds:

* ``md_update``: one row at G = 100; three rows (masked lanes, a row
  with one valid goal, a row that is not live) at G = 1, 12, 32, 33, 65,
  100 and 128 (1 to 4 goals a lane, held in registers) and at 129 and
  3,417 (the layout in shared memory; 3,417 is the wrapper's largest G,
  and 0 and 3,418 raise); two rows with the Bregman loop cut at
  ``max_iters`` = 1 and 3; the rows alone and reversed against the launch
  of three; and the q recurrence's order: with the experts' last costs far
  from their new ones, the kernel's q is the plain version's and stands
  far from the q that fresh costs at every step, or the steps in reverse
  order, would give;
* ``joint_limit``: the trajectories of ``tests/test_torch_learner_kernels.py``
  whose loop runs 1, 3 and 10 passes, alone (no leading dims) and as
  four rows with one not live; the rows alone against the launch; a
  horizon of T = 120 (1,080 elements: a thread takes two; the first
  argmax a tie); sixteen trajectories from fresh seeds (no case chosen),
  each held to the plain version in float64; rows that make no pass on an
  Ainv of NaN (unchanged) beside one that makes a pass (NaN); and two
  equal largest violations, in one warp and in two, where the kernel
  takes the first index as the plain version does;
* the wrapper: ``md_update``'s four outputs as contiguous views of one
  buffer, and every operator's one Autograd kernel, which dispatches
  again below autograd.

Bars: ``p`` and ``experts_p`` atol 1e-6, ``experts_costs`` and ``q`` rtol
1e-5 (the warp reductions sum in another order than torch, and the host's
``logf``/``expf`` round apart from torch's); the trajectory atol 1e-6
(torch's ``Ainv @ tv`` sums the dot products in another order than the
kernel's k order, and the passes carry it), and against float64 no
farther than max(1e-6, 2 x the float32 plain version's own distance); the
rows alone bit for bit.  Rounding in the two orders is random: over 3,000
seeded pushes (``scripts/joint_limit_gaps.py``) the kernel source meets
the float64 bar on all but 7, which stand at most 1.52 times it (3.0e-6
from float64), and JAX on all but 1 (1.08 times it)."""

import ctypes
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from omg_planner_torch.config import OMGConfig
from omg_planner_torch.models import panda
from omg_planner_torch.ops import kernels
from omg_planner_torch.utils.limit_cases import pushed, seeded
from test_torch_learner_kernels import JL_CASES, MD_NAMES, md_close, md_rows

torch.set_num_threads(2)

OPTIM_STEPS = 10


def _compile(out_dir, src, *flags):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    lib = os.path.join(out_dir, f"lib{src}{len(flags)}_emu.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-DOMG_CUDA_EMU", *flags, "-x", "c++",
                    os.path.join(kernels.CSRC, f"{src}.cu"), "-o", lib],
                   check=True, capture_output=True)
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("learner_kernels_emu"))
    fns = {"md_update": _compile(out, "md_update").omg_md_update,
           "joint_limit": _compile(out, "joint_limit").omg_joint_limit}
    for lib, fn in fns.items():
        fn.argtypes = kernels._LIBS[lib][2][fn.__name__]
        fn.restype = ctypes.c_int
    return fns


def _md_emu(fn, rows, live=None, max_iters=20):
    args = [torch.as_tensor(a) for a in rows]
    live = None if live is None else torch.as_tensor(live)
    keep, outs, ptrs, dims = kernels._md_update_pack(*args, live,
                                                     OPTIM_STEPS, max_iters)
    assert fn(ptrs, dims, 1e-6, None) == 0
    del keep
    return outs


def _md_plain(rows, live=None, max_iters=20):
    return kernels.md_update_plain(
        *map(torch.as_tensor, rows),
        None if live is None else torch.as_tensor(live), OPTIM_STEPS,
        max_iters)


def test_md_update_one_row(libs):
    rows = tuple(a[0] for a in md_rows(100, 1, [None]))
    got = _md_emu(libs["md_update"], rows)
    md_close(got, _md_plain(rows))
    assert got[0].shape == (100,) and got[1].shape == (5, 100)


# G = 1 to 128: 1, 2, 3 and 4 goals a lane in registers; 129 and 3,417
# (the wrapper's largest): the shared-memory layout
@pytest.mark.parametrize("g", [1, 12, 32, 33, 65, 100, 128, 129, 3417])
def test_md_update_rows(libs, g):
    rows = md_rows(g, 11 * g, [None, 1, None])
    live = np.array([True, True, False])
    got = _md_emu(libs["md_update"], rows, live)
    md_close(got, _md_plain(rows, live))
    rev = _md_emu(libs["md_update"], tuple(a[::-1].copy() for a in rows),
                  live[::-1].copy())
    for r in range(3):
        one = _md_emu(libs["md_update"], tuple(a[r:r + 1] for a in rows),
                      live[r:r + 1])
        for name, a, b, c in zip(MD_NAMES, one, got, rev):
            assert torch.equal(a[0], b[r]) and torch.equal(c[2 - r], b[r]), (
                name, r)


@pytest.mark.parametrize("max_iters", [1, 3])
def test_md_update_at_max_iters(libs, max_iters):
    rows = md_rows(100, 21, [None, None])
    cut = _md_emu(libs["md_update"], rows, max_iters=max_iters)
    md_close(cut, _md_plain(rows, max_iters=max_iters))
    if max_iters == 1:                 # the cut shows
        full = _md_plain(rows)
        assert float((cut[1] - full[1]).abs().max()) > 1e-5


def test_md_update_keeps_the_q_order(libs):
    """At step i the recurrence takes fresh costs for experts 0..i and the
    last step's for the rest: with last costs of 0 and 4 against new ones
    near 1, another order gives another q."""
    ep, cv, mask, _, q = md_rows(100, 5, [None])
    costs = np.array([[4.0, 0.0, 4.0, 0.0, 4.0]], np.float32)
    rows = (ep, cv, mask, costs, q)
    got = _md_emu(libs["md_update"], rows)
    md_close(got, _md_plain(rows))
    c_new = got[2][0].double().numpy()

    def recurrence(order, fresh_all=False):
        qv = q[0].astype(np.float64)
        seen = set()
        for i in order:
            seen.add(i)
            c = np.array([c_new[k] if (fresh_all or k in seen)
                          else costs[0, k] for k in range(5)])
            qv = qv * np.exp(-c)
            qv = qv / qv.sum()
        return qv
    mine = got[3][0].double().numpy()
    np.testing.assert_allclose(mine, recurrence(range(5)), rtol=1e-5)
    for other in (recurrence(range(5), fresh_all=True),
                  recurrence(range(4, -1, -1))):
        assert np.abs(mine / other - 1).max() > 1e-2


def test_md_update_goal_range():
    """The wrapper takes 1 to 3,417 goals (the shared-memory layout's
    largest block) and raises on 0 or more."""
    for g in (0, 3418):
        rows = [torch.as_tensor(a) for a in md_rows(max(g, 1), 3, [None])]
        if g == 0:
            rows = [r[..., :0] if r.shape[-1] != 5 else r for r in rows]
        else:
            rows = [torch.cat([r, r[..., :1]], -1) if r.shape[-1] != 5 else r
                    for r in rows]
        with pytest.raises(ValueError, match="1 to 3,417"):
            kernels._md_update_pack(*rows, None, OPTIM_STEPS, 20)


def _jl_emu(fn, xi, lo, hi, ainv, live=None):
    keep, out, ptrs, dims = kernels._joint_limit_pack(
        xi, lo, hi, ainv, live, 10)
    assert fn(ptrs, dims, None) == 0
    del keep
    return out


@pytest.fixture(scope="module")
def limits():
    model = panda.load_panda(15, "cpu")
    return model.joint_lower.numpy(), model.joint_upper.numpy()


def _jl_close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_joint_limit_matches_plain(libs, limits):
    lo, hi = map(torch.as_tensor, limits)
    ainv = OMGConfig().horizon().on("cpu").Ainv
    xs = [torch.as_tensor(pushed(limits, *JL_CASES[k]))
          for k in sorted(JL_CASES)]
    for k, xi in zip(sorted(JL_CASES), xs):
        assert len(kernels.limit_loop_trace(xi, lo, hi, ainv, 10)[0]) - 1 == k
        got = _jl_emu(libs["joint_limit"], xi, lo, hi, ainv)
        want = kernels.joint_limit_plain(xi, lo, hi, ainv, None, 10)
        _jl_close(got, want)
        assert float((got - xi).abs().max()) > 1e-3
    xi = torch.stack(xs + [xs[2]])
    live = torch.tensor([True, True, True, False])
    lo4, hi4 = lo.expand(4, 9), hi.expand(4, 9)
    got = _jl_emu(libs["joint_limit"], xi, lo4, hi4, ainv, live)
    _jl_close(got, kernels.joint_limit_plain(xi, lo4, hi4, ainv, live, 10))
    assert torch.equal(got[3], xi[3])
    for r in range(4):
        one = _jl_emu(libs["joint_limit"], xi[r:r + 1], lo4[:1], hi4[:1],
                      ainv, live[r:r + 1])
        assert torch.equal(one[0], got[r])


def test_joint_limit_long_horizon(libs, limits):
    """T = 120 (the 10-pass trajectory four times): 1,080 elements on
    1,024 threads, so some take two; the first pass's argmax is a tie (the
    trajectory repeats), taken at the first index.  Bar: no farther from
    the plain version in float64 than max(1e-6, 2 x the float32 plain
    version's own distance) (length-120 dot products in two orders: the
    kernel stands 9.6e-7 from float64, the plain version 2.8e-6)."""
    lo, hi = map(torch.as_tensor, limits)
    ainv = OMGConfig(timesteps=120).horizon().on("cpu").Ainv
    base = pushed(limits, *JL_CASES[10])
    xi = torch.as_tensor(np.concatenate([base] * 4))
    norms, gaps = kernels.limit_loop_trace(xi, lo, hi, ainv, 10)
    assert len(norms) == 11 and gaps[0] == 0.0
    got = _jl_emu(libs["joint_limit"], xi, lo, hi, ainv)
    plain = kernels.joint_limit_plain(xi, lo, hi, ainv, None, 10)
    f64 = kernels.joint_limit_plain(*(t.double() for t in (xi, lo, hi, ainv)),
                                    None, 10)
    own = float((plain.double() - f64).abs().max())
    assert float((got.double() - f64).abs().max()) <= max(1e-6, 2 * own)
    assert float((got - xi).abs().max()) > 1e-3


def test_joint_limit_seeded_pushes(libs, limits):
    """Sixteen trajectories from fresh seeds, each pushed past the limits
    as ``limit_cases.random_pushes`` draws it (no case chosen), as the
    rows of one launch.  Bar, per row: no farther from the plain version
    in float64 than max(1e-6, 2 x the float32 plain version's own
    distance)."""
    lo, hi = map(torch.as_tensor, limits)
    ainv = OMGConfig().horizon().on("cpu").Ainv
    xi = torch.as_tensor(seeded(limits, range(1000, 1016)))
    lo16, hi16 = lo.expand(16, 9), hi.expand(16, 9)
    got = _jl_emu(libs["joint_limit"], xi, lo16, hi16, ainv)
    plain = kernels.joint_limit_plain(xi, lo16, hi16, ainv, None, 10)
    f64 = kernels.joint_limit_plain(
        *(t.double() for t in (xi, lo16, hi16, ainv)), None, 10)
    for r in range(16):
        own = float((plain[r].double() - f64[r]).abs().max())
        mine = float((got[r].double() - f64[r]).abs().max())
        assert mine <= max(1e-6, 2 * own), (r, mine, own)
    assert float((got - xi).abs().max()) > 1e-3


def test_joint_limit_no_pass_needs_no_ainv(libs, limits):
    """A row whose first check passes (in limits) and a row that is not
    live make no pass: with Ainv all NaN their trajectories come out as
    they went in.  (The kernel starts Ainv's copy before its first check,
    so it reads Ainv on a live row, but uses it only in a pass.)  A row
    with a pass, on the same NaN Ainv, comes out NaN."""
    lo, hi = map(torch.as_tensor, limits)
    nan = torch.full((30, 30), float("nan"))
    xi = torch.stack([torch.as_tensor(pushed(limits, 3, [])),
                      torch.as_tensor(pushed(limits, *JL_CASES[3])),
                      torch.as_tensor(pushed(limits, *JL_CASES[1]))])
    live = torch.tensor([True, False, True])
    got = _jl_emu(libs["joint_limit"], xi, lo.expand(3, 9), hi.expand(3, 9),
                  nan, live)
    assert torch.equal(got[:2], xi[:2])
    assert bool(got[2].isnan().any())


def _last_index_loop(xi, lo, hi, ainv):
    """The plain loop in float64, but with the last index of max |tv| on
    ties (the rule the kernel must not follow)."""
    x, lo, hi, ainv = (t.double() for t in (xi, lo, hi, ainv))
    for _ in range(10):
        tv = kernels._limit_violation(x, lo, hi)
        if float(torch.linalg.norm(tv)) <= 1e-2:
            break
        a = tv.abs().reshape(-1)
        idx = a.numel() - 1 - int(torch.argmax(a.flip(0)))
        tvs = ainv @ tv
        x = x + a.max() / (tvs.reshape(-1)[idx].abs() + 1e-8) * tvs
    return x


@pytest.mark.parametrize("steps", [(0, 3), (2, 25)])
def test_joint_limit_argmax_ties(libs, limits, steps):
    """Joint 4 pushed 0.2 rad past its upper limit at two timesteps alone:
    the two largest |violation|s are equal (flat indices 4 and 31 in one
    warp; 22 and 229 in warps 0 and 7).  The fused reduction takes the
    first index, as torch.argmax: the kernel source is within 1e-6 of the
    plain version and stands far from the loop that takes the last."""
    lo, hi = map(torch.as_tensor, limits)
    ainv = OMGConfig().horizon().on("cpu").Ainv
    xi = torch.as_tensor(pushed(limits, 3, []))
    for t in steps:
        xi[t, 4] = hi[4] + 0.2
    tv = kernels._limit_violation(xi, lo, hi).abs().reshape(-1)
    top = torch.topk(tv, 2)
    assert float(top.values[0]) == float(top.values[1]) > 0.1
    assert sorted(top.indices.tolist()) == [9 * t + 4 for t in steps]
    got = _jl_emu(libs["joint_limit"], xi, lo, hi, ainv)
    _jl_close(got, kernels.joint_limit_plain(xi, lo, hi, ainv, None, 10))
    last = _last_index_loop(xi, lo, hi, ainv)
    assert float((got.double() - last).abs().max()) > 1e-3


@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_md_update_outputs_share_one_buffer(lead):
    """The wrapper makes one allocation for the four outputs: contiguous
    views of the shapes the schema promises, one after another in the
    order the kernel writes them."""
    shapes = [lead + (7,), lead + (5, 7), lead + (5,), lead + (5,)]
    ins = [torch.zeros(lead + (5, 7)), torch.zeros(lead + (7,)),
           torch.ones(lead + (7,), dtype=torch.bool), torch.zeros(lead + (5,)),
           torch.zeros(lead + (5,)), None]
    _, outs, ptrs, _ = kernels._md_update_pack(*ins, 10, 20)
    assert [tuple(o.shape) for o in outs] == shapes
    at = 0
    for o in outs:
        assert o.is_contiguous() and o.dtype == torch.float32
        assert o.data_ptr() == ptrs[6] + 4 * at
        at += o.numel()
    assert at == math.prod(lead) * (6 * 7 + 2 * 5)


def test_operators_reach_the_backend_through_the_dispatcher():
    """Every operator of the library has one Autograd kernel, which
    dispatches again below autograd, and no AutogradCUDA kernel of its
    own: on the card a call reaches the CUDA kernel through every dispatch
    key between (a dispatch mode, fake tensors, functionalization)."""
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    for name in ("panda_fk", "sdf_query_analytic", "sdf_query_baked",
                 "md_update", "joint_limit"):
        op = f"omg_torch::{name}"
        assert all(has(op, key) for key in ("CPU", "CUDA", "Autograd"))
        assert not has(op, "AutogradCUDA")
