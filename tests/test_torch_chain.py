"""The generic URDF chain of the port (``models/chain.py`` and the chain
branch of ``models/api.py``) against the JAX package on the CPU, with the
URDFs of ``tests/test_chain.py`` (a 2-link planar arm) and
``tests/test_chain_plan.py`` (a UR-like 6-DOF arm), kept here as copies.

* FK, a prismatic joint and batched FK: poses within atol 1e-5 of JAX's.
* Point Jacobians (``chain_point_jacobians`` and the planner's
  ``api.point_jacobians``) against ``torch.func.jacfwd`` of the port's own
  FK and against JAX: atol 1e-5.
* ``plan_fast`` and ``plan`` of the one-box chain problem (full
  ``OMGConfig()`` widths, 25+10 steps, ``goal_set_proj=False``) against
  JAX's ``plan_fast``: same verdict and steps, trajectories within 2e-3;
  ``plan`` equals ``plan_fast`` within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_tpu.models import api as japi
from omg_planner_tpu.models import chain as jchain
from omg_planner_tpu.ops import sdf as jsdf
from omg_planner_tpu.ops.chomp import CostParams as JCostParams
from omg_planner_tpu.ops.chomp import GoalSet as JGoalSet
from omg_planner_tpu.planner import plan as jplan
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.models import api as tapi
from omg_planner_torch.models import chain as tchain
from omg_planner_torch.ops import sdf as tsdf
from omg_planner_torch.ops.chomp import CostParams, GoalSet
from omg_planner_torch.planner import plan as tplan

torch.set_num_threads(2)

ATOL = 1e-5

TWO_LINK = """
<robot name="rr">
  <link name="base"/><link name="l1"/><link name="l2"/><link name="tip"/>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.1" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0.5 0 0" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3"/>
  </joint>
  <joint name="jt" type="fixed">
    <parent link="l2"/><child link="tip"/>
    <origin xyz="0.4 0 0" rpy="0 0 0"/>
  </joint>
</robot>
"""


def ur_urdf():
    """A UR5-like 6-DOF serial arm (``tests/test_chain_plan.py``)."""
    def joint(name, parent, child, xyz, rpy, axis):
        return f"""
  <joint name="{name}" type="revolute">
    <parent link="{parent}"/><child link="{child}"/>
    <origin xyz="{xyz}" rpy="{rpy}"/><axis xyz="{axis}"/>
    <limit lower="-3.1" upper="3.1"/>
  </joint>
  <link name="{child}"/>"""

    return ("""<robot name="ur_like">
  <link name="base_link"/>"""
            + joint("shoulder_pan", "base_link", "shoulder", "0 0 0.089",
                    "0 0 0", "0 0 1")
            + joint("shoulder_lift", "shoulder", "upper_arm", "0 0.135 0",
                    "0 1.570796 0", "0 1 0")
            + joint("elbow", "upper_arm", "forearm", "0 -0.119 0.425",
                    "0 0 0", "0 1 0")
            + joint("wrist_1", "forearm", "wrist1", "0 0 0.392",
                    "0 1.570796 0", "0 1 0")
            + joint("wrist_2", "wrist1", "wrist2", "0 0.093 0",
                    "0 0 0", "0 0 1")
            + joint("wrist_3", "wrist2", "tool0", "0 0 0.094",
                    "0 0 0", "0 1 0")
            + "\n</robot>")


def _ur_points(n_joints):
    rng = np.random.default_rng(3)
    pts = rng.normal(scale=0.02, size=(n_joints, 8, 3))
    pts[..., 2] += np.linspace(0, 0.15, 8)[None, :]
    return pts


@pytest.fixture(scope="module")
def ur():
    """(JAX model, port model) of the UR-like arm with the same points."""
    j = jchain.load_urdf_chain(ur_urdf(), "base_link", "tool0",
                               collision_points_per_link=8)
    t = tchain.load_urdf_chain(ur_urdf(), "base_link", "tool0",
                               collision_points_per_link=8, device="cpu")
    pts = _ur_points(j.num_joints)
    return (jchain.with_collision_points(j, pts),
            tchain.with_collision_points(t, pts))


def test_two_link_fk_matches_jax():
    j = jchain.load_urdf_chain(TWO_LINK, "base", "tip")
    t = tchain.load_urdf_chain(TWO_LINK, "base", "tip", device="cpu")
    assert t.num_joints == 3 and t.num_dof == 2 and t.jtype == j.jtype
    np.testing.assert_array_equal(t.collision_points.numpy(),
                                  np.asarray(j.collision_points))
    q = np.array([np.pi / 2, -np.pi / 2], np.float32)
    poses = tchain.chain_fk(t, torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(poses[1][:3, 3], [0.0, 0.5, 0.1], atol=1e-6)
    np.testing.assert_allclose(poses[2][:3, 3], [0.4, 0.5, 0.1], atol=1e-6)
    np.testing.assert_allclose(
        poses, np.asarray(jchain.chain_fk(j, jnp.asarray(q))), atol=ATOL)
    for tl, jl in zip(t.soft_limits(0.2), j.soft_limits(0.2)):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-7)


def test_prismatic_joint_matches_jax():
    urdf = TWO_LINK.replace('<joint name="j2" type="revolute">',
                            '<joint name="j2" type="prismatic">')
    j = jchain.load_urdf_chain(urdf, "base", "tip")
    t = tchain.load_urdf_chain(urdf, "base", "tip", device="cpu")
    q = np.array([0.3, 0.25], np.float32)
    poses = tchain.chain_fk(t, torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(
        poses, np.asarray(jchain.chain_fk(j, jnp.asarray(q))), atol=ATOL)
    p0 = tchain.chain_fk(t, torch.tensor([0.0, 0.25])).numpy()
    np.testing.assert_allclose(p0[1][:3, 3], [0.5, 0.0, 0.35], atol=1e-6)


def test_batched_fk_matches_jax(ur):
    jm, tm = ur
    qs = np.random.default_rng(0).uniform(-1, 1, (5, 6)).astype(np.float32)
    tb = tchain.chain_fk_batch(tm, torch.as_tensor(qs))
    assert tb.shape == (5, 6, 4, 4)
    np.testing.assert_allclose(
        tb.numpy(), np.asarray(jchain.chain_fk_batch(jm, jnp.asarray(qs))),
        atol=ATOL)
    np.testing.assert_allclose(
        tb[2].numpy(), tchain.chain_fk(tm, torch.as_tensor(qs[2])).numpy(),
        atol=1e-6)
    tp, to, ta = tapi.fk_with_joint_info_batch(tm, torch.as_tensor(qs))
    jp, jo, ja = japi.fk_with_joint_info_batch(jm, jnp.asarray(qs))
    for a, b in ((tp, jp), (to, jo), (ta, ja)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_point_jacobians_match_jacfwd_and_jax(ur):
    two_j = jchain.load_urdf_chain(TWO_LINK, "base", "tip",
                                   collision_points_per_link=4)
    two_t = tchain.load_urdf_chain(TWO_LINK, "base", "tip",
                                   collision_points_per_link=4, device="cpu")
    q2 = np.array([0.3, -0.7], np.float32)
    jac, x = tchain.chain_point_jacobians(two_t, torch.as_tensor(q2))

    def pts(qq):
        poses = tchain.chain_fk(two_t, qq)
        return (torch.einsum("jab,jpb->jpa", poses[:, :3, :3],
                             two_t.collision_points) + poses[:, None, :3, 3])

    auto = torch.func.jacfwd(pts)(torch.as_tensor(q2))   # [J, P, 3, D]
    np.testing.assert_allclose(jac.numpy(), auto.movedim(-1, -2).numpy(),
                               atol=ATOL)
    jjac, jx = jchain.chain_point_jacobians(two_j, jnp.asarray(q2))
    np.testing.assert_allclose(jac.numpy(), np.asarray(jjac), atol=ATOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=ATOL)

    # the planner's route (api._chain_tables) on the UR-like arm
    jm, tm = ur
    q = np.array([0.3, -0.7, 1.1, -0.4, 0.8, 0.2], np.float32)
    poses, og, ax = tchain.chain_fk(tm, torch.as_tensor(q),
                                    return_joint_info=True)
    xt = tapi.point_positions(tm, poses)
    ours = tapi.point_jacobians(tm, og[None], ax[None], xt[None])[0]
    auto = torch.func.jacfwd(lambda qq: tapi.point_positions(
        tm, tchain.chain_fk(tm, qq)))(torch.as_tensor(q))
    np.testing.assert_allclose(ours.numpy(), auto.movedim(-1, -2).numpy(),
                               atol=ATOL)
    jposes, jog, jax_ = jchain.chain_fk(jm, jnp.asarray(q),
                                        return_joint_info=True)
    theirs = japi.point_jacobians(jm, jog[None], jax_[None],
                                  japi.point_positions(jm, jposes)[None])[0]
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL)
    assert tapi.dof(tm) == 6
    assert not tapi.finger_link_mask(tm).any()
    assert tapi.arm_dof_mask(tm).all()
    assert torch.equal(tapi.gripper_clamp(tm, xt), xt)


START = np.array([0.0, -1.2, 1.6, -0.5, 0.0, 0.0], np.float32)
END = np.array([1.2, -0.9, 1.2, -0.8, 0.6, 0.3], np.float32)
BOX_POSE = np.eye(4)
BOX_POSE[:3, 3] = [0.7, 0.0, 0.3]  # a pillar off to the robot's side


def _box(sdf_cls):
    sdf = sdf_cls.from_analytic("box", [0.2, 0.2, 0.4], delta=0.02)
    return sdf.penalize_inside(5.0)


def _jax_problem(model, cfg):
    start, end = jnp.asarray(START), jnp.asarray(END)
    lo, hi = model.soft_limits(cfg.soft_joint_limit_padding)
    return jplan.PlanProblem(
        start=start, end=end,
        traj_init=jplan.init_trajectory(cfg, start, end),
        goal_set=JGoalSet(
            grasps=jnp.tile(end[None], (4, 1)),
            reach_grasps=jnp.tile(end[None, None],
                                  (4, cfg.reach_tail_length, 1)),
            mask=jnp.ones(4, bool), potentials=jnp.zeros(4)),
        scene=jsdf.combine_sdfs([_box(jsdf.SignedDensityField)]),
        cost_params=JCostParams(
            inv_poses=jnp.asarray(np.linalg.inv(BOX_POSE)[None], jnp.float32),
            epsilons=jnp.asarray([0.2]), padding_scales=jnp.asarray([1.0]),
            clearances=jnp.asarray([0.0]), disables=jnp.asarray([0.0]),
            target_idx=jnp.asarray(0, jnp.int32)),
        joint_lower=lo, joint_upper=hi,
        world_potential=jsdf.WorldPotential(
            data=jnp.zeros((2, 2, 2)), origin=jnp.zeros(3),
            delta=jnp.asarray(1.0)))


def chain_problem(model, cfg):
    """The port's one-box chain problem on ``model.device``."""
    d = model.device
    start, end = torch.as_tensor(START, device=d), torch.as_tensor(END,
                                                                  device=d)
    lo, hi = model.soft_limits(cfg.soft_joint_limit_padding)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=d)

    return tplan.PlanProblem(
        start=start, end=end,
        traj_init=tplan.init_trajectory(cfg, start, end),
        goal_set=GoalSet(
            grasps=end[None].repeat(4, 1),
            reach_grasps=end[None, None].repeat(4, cfg.reach_tail_length, 1),
            mask=torch.ones(4, dtype=torch.bool, device=d),
            potentials=torch.zeros(4, device=d)),
        scene=tsdf.combine_sdfs([_box(tsdf.SignedDensityField)], d),
        cost_params=CostParams(
            inv_poses=f32(np.linalg.inv(BOX_POSE)[None]), epsilons=f32([0.2]),
            padding_scales=f32([1.0]), clearances=f32([0.0]),
            disables=f32([0.0]), target_idx=torch.tensor(0, device=d)),
        joint_lower=lo, joint_upper=hi,
        world_potential=tsdf.WorldPotential(
            data=torch.zeros((2, 2, 2), device=d),
            origin=torch.zeros(3, device=d),
            delta=torch.tensor(1.0, device=d)))


CHAIN_CFG = dict(silent=True, goal_set_proj=False, use_standoff=False,
                 optim_steps=25, extra_smooth_steps=10)


def test_chain_plans_match_jax(ur):
    jm, tm = ur
    jcfg, tcfg = JConfig(**CHAIN_CFG), OMGConfig(**CHAIN_CFG)
    jres = jax.jit(jplan.plan_fast, static_argnums=(1,))(
        jm, jcfg, _jax_problem(jm, jcfg))
    problem = chain_problem(tm, tcfg)
    tres = tplan.plan_fast(tm, tcfg, problem)
    assert tres.traj.shape == (tcfg.timesteps, 6)
    assert bool(tres.flag) == bool(jres.flag)
    assert int(tres.steps_used) == int(jres.steps_used)
    np.testing.assert_allclose(tres.traj.numpy(), np.asarray(jres.traj),
                               atol=2e-3)
    assert np.abs(tres.traj.numpy()[-1] - END).max() < 0.15
    assert float(tres.info.collide) <= tcfg.allow_collision_point
    hist = tplan.plan(tm, tcfg, problem)
    np.testing.assert_allclose(hist.traj.numpy(), tres.traj.numpy(),
                               atol=1e-5)
    assert hist.history.shape == (tcfg.total_steps, tcfg.timesteps, 6)
