"""The CHOMP step's operators (``ops/kernels.py``: ``chomp_obstacle``, the
obstacle cost and gradient, and ``chomp_step``, smoothness, the total
loss, the flags and the update) on the CPU, where they run their plain
versions, against the JAX package on the same inputs.

Problem: ``data/suite_v2`` scene 1 at ``tests/test_golden.py::CFG`` (T =
30, 10 links x 15 points = 4,500 points), its analytic scene and
collision parameters staged by the JAX package and carried across with
``interop``; trajectories are the start-to-end spline plus numpy noise
from fixed seeds, so the collision terms and the top-k mask have work to
do.  ``compute_collision_loss`` (the port: FK, the query, one
``chomp_obstacle`` call) is held to JAX's in each case:

* default (``top_k_collision`` = 1,000 of 4,500), ``ref_topk_quirks``,
  ``consider_finger``, ``uncheck_finger_collision=-1``,
  ``goal_set_proj=False`` and k >= T L P;
* the query replaced, in both packages, by the same seeded potentials
  with many ties at the k-th value: values of {0.5, 0.25, 0.0, -0.0}, the
  k-th a 0.25 in a run of ties, and one where it is a zero among +0.0 and
  -0.0 (the mask then takes every zero of either sign);
* the fused field: both packages' ``world_field_query`` on one seeded
  ``WorldField`` (``cfg.sdf_fused``);
* the UR-like 6-DOF chain of ``tests/test_torch_chain.py`` (its own
  Jacobian tables, no fingers) with seeded potentials.

``chomp_step`` (``ops/chomp.py::chomp_step``) is held to JAX's
``compute_total_loss``, ``check_joint_limit`` and
``goal_set_projection_update``/``unconstrained_update`` then
``apply_update``, with and without the goal-set projection, both on the
port's obstacle terms (JAX's ``compute_collision_loss`` replaced by
them: the cases above hold those terms).  Also: a
vmap of 3 scenes equals the per-scene calls bit for bit, and both
operators raise on an input that requires grad.

Tolerances: costs rtol 1e-4 and atol 1e-6 (float32 sums of 4,500 point
terms in another order); gradients atol 2e-3 of their largest entry, as
``tests/test_torch_chomp_learner.py``, or where the two packages part by
more, the port no farther from JAX's own float64 run on the same query
outputs than JAX's float32 (the direction divides by |v|^2, which
magnifies float32 rounding where the points barely move: suite scene 1,
seed 7, one entry 0.044 apart, JAX 0.047 from float64, the port 0.004;
:func:`grad_close`, :func:`jax_f64`).  Each case also shows that a
gradient with its sign flipped, or with its largest dof dropped, fails
that check.  Collision counts, the k-th value, the mask and the flags
exact; the updated trajectory atol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.config import schedule_weights as jschedule
from omg_planner_tpu.models import api as japi
from omg_planner_tpu.models import chain as jchain
from omg_planner_tpu.ops import chomp as jchomp
from omg_planner_tpu.ops.sdf import WorldField as JWorldField
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_tpu.utils.spline import cubic_interpolate as jspline
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.config import schedule_weights as tschedule
from omg_planner_torch.models import api as tapi
from omg_planner_torch.models import chain as tchain
from omg_planner_torch.ops import chomp as tchomp
from omg_planner_torch.ops import kernels
from omg_planner_torch.ops.sdf import WorldField as TWorldField
from test_golden import CFG
from test_torch_chain import _ur_points, ur_urdf

torch.set_num_threads(2)

SUITE_1 = "data/suite_v2/scene_1.npz"


def T(a):
    return torch.as_tensor(np.array(a))


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


def close(t, j, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=rtol)


def grad_close(t, j, w):
    """The port's gradient ``t`` within 2e-3 of JAX's ``j`` (of its
    largest entry), or, entry by entry, no farther from JAX's float64
    witness ``w`` (:func:`jax_f64`) than JAX's own float32 stands: where a
    point barely moves (|v| ~ 1e-4) the direction's 1 / |v|^2 carries each
    package's float32 rounding far."""
    t, j, w = np.asarray(t), np.asarray(j), np.asarray(w)
    atol = 2e-3 * max(1.0, float(np.abs(j).max()))
    ok = (np.abs(t - j) <= atol) | (np.abs(t - w) <= np.abs(j - w) + atol)
    assert ok.all(), (np.abs(t - j).max(), np.argwhere(~ok))


def check_grad(t, j, w):
    """:func:`grad_close`, and a planted wrong gradient fails it: the sign
    flipped, or the dof of JAX's largest entry dropped."""
    grad_close(t, j, w)
    t = np.asarray(t)
    drop = t.copy()
    drop[:, np.abs(np.asarray(j)).max(0).argmax()] = 0.0
    for bad in (-t, drop):
        with pytest.raises(AssertionError):
            grad_close(bad, j, w)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(
        jnp.asarray(a).dtype, jnp.floating) else a, tree)


def jax_query(jm, scene, params, xi, jwf=None):
    """JAX's collision query outputs on its forward kinematics of ``xi``."""
    poses, _, _ = japi.fk_with_joint_info_batch(jm, xi)
    pts = japi.point_positions(jm, poses).reshape(-1, 3)
    if jwf is not None:
        return jchomp.world_field_query(jwf, pts)
    return jchomp.sdf_potentials(scene, params.inv_poses, pts,
                                 params.epsilons, params.padding_scales,
                                 params.clearances, params.disables)


def jax_f64(monkeypatch, query, jm, scene, params, cfg, xi, start, end,
            jwf=None):
    """JAX's ``compute_collision_loss`` in float64: the model, trajectory
    and ends in float64, the float32 run's collision query outputs
    (:func:`jax_query`) held fixed, so the selection is the float32 run's
    and only the cost and gradient arithmetic changes precision."""
    with jax.enable_x64(True):
        q64 = tuple(jnp.asarray(np.asarray(a), jnp.float64) for a in query)
        monkeypatch.setattr(jchomp, "sdf_potentials", lambda *a: q64)
        monkeypatch.setattr(jchomp, "world_field_query", lambda *a: q64)
        out = jax.jit(lambda m, xi, s, e: jchomp.compute_collision_loss(
            m, scene, params, cfg, cfg.horizon(), xi, s, e,
            world_field=jwf))(*_f64((jm, xi, start, end)))
        assert out[1].dtype == jnp.float64
        return [np.asarray(o) for o in out]


def port_loss(tm, scene, params, cfg, xi, start, end, field=None):
    """The port's ``compute_collision_loss``."""
    return tchomp.compute_collision_loss(tm, scene, params, cfg,
                                         cfg.horizon().on("cpu"), xi, start,
                                         end, world_field=field)


@pytest.fixture(scope="module")
def staged():
    js = JScene.from_npz(CFG, SUITE_1)
    scene, params = js.env.scene_sdf(), js.env.cost_params()
    start = np.asarray(js.start, np.float32)
    end = np.asarray(js.end, np.float32)
    base = np.asarray(jspline(jnp.asarray(start), jnp.asarray(end),
                              CFG.timesteps))
    rng = np.random.default_rng(7)
    noise = rng.normal(scale=0.15, size=base.shape).astype(np.float32)
    noise[:, 7:] = 0.0
    tail = (end[None] + rng.normal(scale=0.02, size=(
        CFG.reach_tail_length, 9))).astype(np.float32)
    nmodel = jax.tree.map(np.asarray, js.model)
    return dict(
        jmodel=js.model, jscene=scene, jparams=params,
        tmodel=interop.panda_model(nmodel, "cpu"),
        tscene=interop.scene(jax.tree.map(np.asarray, scene), "cpu"),
        tparams=interop.cost_params(jax.tree.map(np.asarray, params), "cpu"),
        start=start, end=end, tail=tail, xi=base + noise, lower=np.asarray(
            js.model.joint_lower), upper=np.asarray(js.model.joint_upper))


def _crafted(shape, ties: str, seed: int):
    """Seeded query outputs (pot, grad, collide) of T L P points: values
    of {0.5, 0.25, 0.0, -0.0} with the 1,000th largest a 0.25 among ties
    (``ties="quarter"``) or a zero among +0.0 and -0.0 (``"zero"``)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    counts = ((400, 1400) if ties == "quarter" else (300, 500))
    pot = np.zeros(n, np.float32)
    order = rng.permutation(n)
    pot[order[:counts[0]]] = 0.5
    pot[order[counts[0]:counts[1]]] = 0.25
    neg = order[counts[1]:][rng.random(n - counts[1]) < 0.5]
    pot[neg] = -0.0
    grad = rng.normal(size=(n, 3)).astype(np.float32)
    collide = (pot > 0.4).astype(np.float32)
    return pot, grad, collide


def _with_query(monkeypatch, arrays):
    """Both packages' collision query replaced by ``arrays``."""
    pot, grad, collide = arrays
    monkeypatch.setattr(jchomp, "sdf_potentials", lambda *a: (
        jnp.asarray(pot), jnp.asarray(grad), jnp.asarray(collide)))
    monkeypatch.setattr(tchomp, "sdf_potentials", lambda *a: (
        T(pot), T(grad), T(collide)))


def _field(seed=11):
    """A seeded fused field over the workspace, in both packages."""
    rng = np.random.default_rng(seed)
    shape = (24, 24, 24)
    data = np.zeros(shape + (5,), np.float32)
    data[..., 0] = np.clip(rng.normal(0.05, 0.1, shape), 0, None)
    data[..., 1:4] = rng.normal(size=shape + (3,))
    data[..., 4] = rng.normal(0.1, 0.1, shape)
    origin = np.array([-0.2, -0.8, -0.2], np.float32)
    delta = np.float32(0.06)
    return (JWorldField(jnp.asarray(data), jnp.asarray(origin),
                        jnp.asarray(delta)),
            TWorldField(T(data), T(origin), T(delta)))


CASES = {
    "default": {},
    "ref_topk_quirks": dict(ref_topk_quirks=True),
    "consider_finger": dict(consider_finger=True),
    "uncheck_finger_collision=-1": dict(uncheck_finger_collision=-1),
    "goal_set_proj=False": dict(goal_set_proj=False),
    "k>=TLP": dict(top_k_collision=4500),
    "ties at 0.25": dict(ties="quarter"),
    "ties at +-0.0": dict(ties="zero"),
    "ties at +-0.0, quirks, softened": dict(
        ties="zero", ref_topk_quirks=True, uncheck_finger_collision=-1),
    "fused field": dict(field=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_collision_loss_matches_jax(staged, monkeypatch, case):
    spec = dict(CASES[case])
    ties, field = spec.pop("ties", None), spec.pop("field", False)
    cfg = CFG.replace(**spec)
    tc = tcfg(cfg)
    if ties:
        _with_query(monkeypatch, _crafted((30, 10, 15), ties, 5))
    jwf, twf = _field() if field else (None, None)
    xi, goal = staged["xi"], staged["end"]
    fn = jax.jit(lambda xi: (jchomp.compute_collision_loss(
        staged["jmodel"], staged["jscene"], staged["jparams"], cfg,
        cfg.horizon(), xi, jnp.asarray(staged["start"]), jnp.asarray(goal),
        world_field=jwf), jax_query(staged["jmodel"], staged["jscene"],
                                    staged["jparams"], xi, jwf)))
    (jc, jg, jn), query = fn(jnp.asarray(xi))
    tcst, tg, tn = port_loss(
        staged["tmodel"], staged["tscene"], staged["tparams"], tc, T(xi),
        T(staged["start"]), T(goal), twf)
    close(tcst, jc, rtol=1e-4)
    check_grad(tg, jg, jax_f64(
        monkeypatch, query, staged["jmodel"], staged["jscene"],
        staged["jparams"], cfg, xi, staged["start"], goal, jwf)[1])
    assert float(tn) == float(jn)
    assert float(np.abs(np.asarray(jg)).max()) > 0  # the case has work
    if ties:
        # the k-th value sits in a run of ties: the mask takes all of it
        pot = _crafted((30, 10, 15), ties, 5)[0]
        kth, sel = kernels.obstacle_selection(
            T(pot).reshape(30, 10, 15), tapi.jacobian_tables(
                staged["tmodel"]), cfg.top_k_collision, cfg.consider_finger)
        want = 0.25 if ties == "quarter" else 0.0
        assert float(kth) == want and (pot == want).sum() > 100
        keep = np.ones(10, np.float32)
        keep[-2:] = float(cfg.consider_finger)
        np.testing.assert_array_equal(
            sel.numpy(), (pot.reshape(30, 10, 15) >= want) * keep[:, None])


def test_chain_collision_loss_matches_jax(staged, monkeypatch):
    jm = jchain.load_urdf_chain(ur_urdf(), "base_link", "tool0",
                                collision_points_per_link=8)
    tm = tchain.load_urdf_chain(ur_urdf(), "base_link", "tool0",
                                collision_points_per_link=8, device="cpu")
    pts = _ur_points(jm.num_joints)
    jm = jchain.with_collision_points(jm, pts)
    tm = tchain.with_collision_points(tm, pts)
    n_links, dof = tapi.num_links(tm), tapi.dof(tm)
    rng = np.random.default_rng(9)
    pot = np.clip(rng.normal(0.0, 0.2, 30 * n_links * 8), 0, None)
    _with_query(monkeypatch, (pot.astype(np.float32), rng.normal(
        size=(pot.size, 3)).astype(np.float32), (pot > 0.3).astype(
            np.float32)))
    cfg = CFG.replace(goal_set_proj=False, top_k_collision=300)
    tc = tcfg(cfg)
    start = np.zeros(dof, np.float32)
    end = np.full(dof, 0.8, np.float32)
    xi = np.linspace(start, end, 30).astype(np.float32) + rng.normal(
        scale=0.05, size=(30, dof)).astype(np.float32)
    (jc, jg, jn), query = jax.jit(lambda xi: (jchomp.compute_collision_loss(
        jm, staged["jscene"], staged["jparams"], cfg, cfg.horizon(), xi,
        jnp.asarray(start), jnp.asarray(end)), jax_query(
            jm, staged["jscene"], staged["jparams"], xi)))(jnp.asarray(xi))
    tcst, tg, tn = port_loss(tm, staged["tscene"], staged["tparams"], tc,
                             T(xi), T(start), T(end))
    assert tg.shape == (30, dof) and tcst.shape == (30, n_links)
    close(tcst, jc, rtol=1e-4)
    check_grad(tg, jg, jax_f64(monkeypatch, query, jm, staged["jscene"],
                               staged["jparams"], cfg, xi, start, end)[1])
    assert float(tn) == float(jn)


@pytest.mark.parametrize("proj", [True, False])
def test_step_matches_jax(staged, monkeypatch, proj):
    cfg = CFG.replace(goal_set_proj=proj)
    tc = tcfg(cfg)
    jhp, thp = cfg.horizon(), tc.horizon().on("cpu")
    jm, tm = staged["jmodel"], staged["tmodel"]
    goal, tail = staged["end"], staged["tail"]
    if not proj:
        tail = goal[None]
    lower, upper = staged["lower"], staged["upper"]
    for step, xi in ((0, staged["xi"]), (7, staged["xi"] * 0.9)):
        ow, sw, _, eta = jschedule(cfg, step + 1)
        tw = tschedule(tc, step + 1)
        xi = np.clip(xi, lower, upper).astype(np.float32)
        if step:  # over an upper limit and under a lower one
            xi[3, 1] = upper[1] + 0.1
            xi[4, 2] = lower[2] - 0.1

        obs = tchomp.compute_collision_loss(
            tm, staged["tscene"], staged["tparams"], tc, thp, T(xi),
            T(staged["start"]), T(goal))
        # JAX's step on the port's obstacle terms (held to JAX's above)
        monkeypatch.setattr(jchomp, "compute_collision_loss", lambda *a, **k:
                            tuple(jnp.asarray(o.numpy()) for o in obs))

        def jstep(xi):
            _, jg, ji = jchomp.compute_total_loss(
                jm, staged["jscene"], staged["jparams"], cfg, jhp, xi,
                jnp.asarray(staged["start"]), jnp.asarray(goal),
                jnp.asarray(goal), ow, sw)
            over = jchomp.check_joint_limit(xi, jnp.asarray(lower),
                                            jnp.asarray(upper))
            if proj:
                upd = jchomp.goal_set_projection_update(
                    jhp, cfg, xi, jg, jnp.asarray(tail), eta)
            else:
                upd = jchomp.unconstrained_update(jhp, jg, eta)
            ji = ji._replace(violate_limit=over,
                             terminate=ji.terminate & ~over)
            return jchomp.apply_update(jm, cfg, xi, upd), ji

        jx, ji = jax.jit(jstep)(jnp.asarray(xi))
        tx, ti = tchomp.chomp_step(tm, tc, thp, T(xi), T(staged["start"]),
                                   T(goal), T(tail), obs,
                                   (tw[0], tw[1], tw[3]), T(lower), T(upper))
        close(tx, jx, atol=1e-5)
        assert bool(ti.violate_limit) == bool(ji.violate_limit) == bool(step)
        for name in ji._fields:
            a, b = getattr(ti, name), getattr(ji, name)
            if b.dtype == bool:
                assert bool(a) == bool(b), name
            else:
                close(a, b, atol=1e-4, rtol=1e-4)


def _rows(staged, n=3):
    """n scenes' inputs of both operators (seeded trajectories of suite
    scene 1) and the per-scene calls."""
    cfg = tcfg(CFG)
    hp = cfg.horizon().on("cpu")
    model = staged["tmodel"]
    rng = np.random.default_rng(21)
    xis = T(staged["xi"][None] + rng.normal(scale=0.05, size=(n, 30, 9))
            .astype(np.float32))
    xis[:, :, 7:] = T(staged["xi"])[None, :, 7:]
    obs_in, step_in = [], []
    for xi in xis:
        x, og, ax, pot, grad, col = tchomp._fk_query(
            model, staged["tscene"], staged["tparams"], xi, None)
        xs, xe = tapi.end_points(model, T(staged["start"]), T(staged["end"]))
        obs_in.append((x, og, ax, xs, xe, pot, grad, col))
        o = kernels.chomp_obstacle(
            *obs_in[-1], hp.diff_matrices, tapi.jacobian_tables(model),
            hp.time_interval, cfg.top_k_collision, cfg.consider_finger,
            False, False)
        w = tschedule(cfg, 3)
        step_in.append((xi, T(staged["start"]), T(staged["end"]),
                        T(staged["tail"])) + o + (w[0], w[1], w[3],
                                                   T(staged["lower"]),
                                                   T(staged["upper"])))
    m_k, p_k = hp.proj[cfg.reach_tail_length]
    obs_shared = (hp.diff_matrices, tapi.jacobian_tables(model),
                  hp.time_interval, cfg.top_k_collision, cfg.consider_finger,
                  False, False)
    step_shared = (hp.diff_matrices[0], hp.A, p_k, m_k,
                   tapi.dof_tables(model), hp.time_interval,
                   cfg.clip_grad_scale, float(cfg.allow_collision_point),
                   cfg.terminate_smooth_loss, True, True, False)
    return obs_in, obs_shared, step_in, step_shared


def test_vmap_of_three_scenes_equals_their_calls(staged):
    obs_in, obs_shared, step_in, step_shared = _rows(staged)
    for op, rows, shared in ((kernels.chomp_obstacle, obs_in, obs_shared),
                             (kernels.chomp_step, step_in, step_shared)):
        stacked = [torch.stack(a) for a in zip(*rows)]
        batch = torch.func.vmap(lambda *r: op(*r, *shared))(*stacked)
        for i, r in enumerate(rows):
            one = op(*r, *shared)
            for a, b in zip(batch, one):
                assert torch.equal(a[i], b), op.__name__


def test_operators_raise_on_requires_grad(staged):
    obs_in, obs_shared, step_in, step_shared = _rows(staged, 1)
    x = obs_in[0][0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no autograd"):
        kernels.chomp_obstacle(x, *obs_in[0][1:], *obs_shared)
    xi = step_in[0][0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no autograd"):
        kernels.chomp_step(xi, *step_in[0][1:], *step_shared)
