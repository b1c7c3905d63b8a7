"""The port's plan executor (``omg_planner_torch/physics/executor.py``)
against the JAX package's on the CPU: the JAX package plans synthetic scene
0 at ``tests/test_physics.py``'s config, and both executors replay the same
trajectory.

Tolerances, and why:
* tracks, static world, pad geometry and the lift's IK waypoints: 1e-4
  (float32 FK and a 12-iteration damped Newton per stage);
* the executed grasp: the same reward, and ``lifted_m``, ``hand_dist_m``
  and ``finger_stop_m`` within 1e-4 m (float32 op-order differences over
  415 substeps of a held grip; the gap on this rollout is far below it);
* the placement (``sub_plan=6`` instead of 24, so the file stays near two
  minutes on the CPU): the same reward and ``carried``, errors within
  1e-3 m.
The air grasp, the too-heavy object and the finger-command clip are the
JAX package's own checks on the port."""

import numpy as np
import pytest
import torch

from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_tpu.physics import executor as jex
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.physics import NoMassModelError, execute_place
from omg_planner_torch.physics import executor as tex
from omg_planner_torch.planner.scene import PlanningScene

torch.set_num_threads(2)
KW = dict(silent=True, optim_steps=15, extra_smooth_steps=5,
          goal_set_max_num=12, ik_seed_num=3, ik_max_iters=30,
          learner_interp_steps=10)


@pytest.fixture(scope="module")
def planned():
    """(JAX scene, port scene, the JAX plan's trajectory)."""
    js = JScene.synthetic(JConfig(**KW), scene_id=0, n_obstacles=1)
    res = js.step(fast=True)
    assert res is not None and bool(res.flag)
    ts = PlanningScene.synthetic(OMGConfig(**KW), scene_id=0, n_obstacles=1,
                                 device="cpu")
    return js, ts, np.asarray(res.traj, np.float64)


@pytest.fixture(scope="module")
def picked(planned):
    """Both executions of the planned grasp, with their traces."""
    js, ts, traj = planned
    return (jex.execute_plan(js, traj, return_trace=True),
            tex.execute_plan(ts, traj, return_trace=True))


def test_tracks_world_and_lift_match_jax(planned):
    js, ts, traj = planned
    jv_ref = np.clip(traj[0, -2:], 0.0, 0.04).astype(np.float32)
    j_lift = jex._lift_configs(js, traj[-1], 0.3, 10)
    t_lift = tex._lift_configs(ts, traj[-1], 0.3, 10)
    np.testing.assert_allclose(t_lift, j_lift, atol=1e-4)
    j_cfg, j_cmd, j_end = jex._config_track(traj, j_lift, jv_ref, 6, 90, 12,
                                            30)
    t_cfg, t_cmd, t_end = tex._config_track(traj, j_lift, jv_ref, 6, 90, 12,
                                            30)
    np.testing.assert_array_equal(t_cfg, j_cfg)
    np.testing.assert_array_equal(t_cmd, j_cmd)
    # a pick rollout of a 30-waypoint plan: 416 boundaries, 415 substeps
    assert t_end == j_end == 205 and t_cfg.shape == (416, 9)

    jw = jex._static_world(js.env, pad_to=6, cfg=js.cfg)
    tw = tex._static_world(ts.env, pad_to=6, cfg=ts.cfg, device="cpu")
    for f in ("kinds", "halfs", "rounds", "inv_poses", "mask"):
        np.testing.assert_allclose(getattr(tw, f).numpy(),
                                   np.asarray(getattr(jw, f)), atol=1e-6,
                                   err_msg=f)
    assert tw.grid4 is None and jw.grid4 is None
    jm, tm = jex._phys_model(), tex._phys_model(torch.device("cpu"))
    for a, b in zip(tex._pad_geometry(tm), jex._pad_geometry(jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(tex._pad_axes(tm, traj[-1]),
                               jex._pad_axes(jm, traj[-1]), atol=1e-4)
    spec = tex._body_spec_for(ts.env.target, 300.0, device="cpu")
    surf_w = (np.asarray(ts.env.target.pose_mat[:3, 3], np.float32)
              + spec.surf.numpy() @ ts.env.target.pose_mat[:3, :3].T)
    assert tex._lift_clearance(tw, surf_w, 0.3) == pytest.approx(
        jex._lift_clearance(jw, surf_w, 0.3))


def test_planned_grasp_report_matches_jax(picked):
    (jrep, jtr), (trep, ttr) = picked
    assert trep.reward == jrep.reward == 1, (trep, jrep)
    for f in ("lifted_m", "hand_dist_m", "finger_stop_m"):
        assert abs(getattr(trep, f) - getattr(jrep, f)) < 1e-4, f
    # tests/test_physics.py::test_planned_grasp_lifts on the port
    assert trep.lifted_m > 0.25 and trep.moved_in_playback_m < 0.02
    assert trep.grasp_impulse > 0.05
    # the settle phase: the body rests on the table in both
    np.testing.assert_allclose(ttr["x"][:30], jtr["x"][:30], atol=1e-5)
    assert ttr["x"].shape == (415, 3)


def test_air_grasp_fails(planned):
    """Closing the gripper away from the object scores 0 with zero grasp
    force."""
    _, ts, traj = planned
    bad = traj.copy()
    bad[-1] = np.asarray(ts.start)
    rep = tex.execute_plan(ts, bad)
    assert rep.reward == 0, rep.to_dict()
    assert rep.grasp_impulse == 0.0, rep.to_dict()


def test_too_heavy_object_slips(planned):
    """40x the design mass exceeds the motor and friction budget."""
    _, ts, traj = planned
    rep = tex.execute_plan(ts, traj, density=12000.0)
    assert rep.reward == 0, rep.to_dict()
    assert rep.lifted_m < 0.05, rep.to_dict()


def test_finger_command_clipped_to_joint_range():
    traj = np.zeros((4, 9), np.float32)
    traj[:, -2:] = 0.1                      # out-of-range plan fingers
    lift_qs = np.zeros((2, 9), np.float32)
    jv_ref = np.clip(traj[0, -2:], 0.0, 0.04)
    configs, jv_cmd, playback_end = tex._config_track(
        traj, lift_qs, jv_ref, sub_plan=2, sub_close=3, sub_lift=2, settle=2)
    assert float(jv_cmd.max()) <= 0.04 and float(jv_cmd.min()) >= 0.0
    assert (jv_cmd[playback_end:] == 0.0).all()
    assert (configs[:, -2:] == 0.04).all()


def test_no_mass_model_error_is_typed():
    class FakeField:
        analytic = None

    class FakeTarget:
        sdf = FakeField()
        points = None

    assert issubclass(NoMassModelError, ValueError)
    with pytest.raises(NoMassModelError):
        tex._body_spec_for(FakeTarget(), density=300.0, device="cpu")


def test_place_execution_matches_jax(planned):
    """A placement planned by the JAX task layer, executed by both."""
    from omg_planner_tpu.planner.tasks import place_target

    js, ts, traj = planned
    t = js.env.target
    orig_pose = t.pose_mat.copy()
    place_pose = orig_pose.copy()
    place_pose[:3, 3] += np.asarray([0.10, 0.06, 0.0])
    js.attach_target(traj[-1])
    rel = t.rel_hand_pose.copy()
    try:
        res, _ = place_target(js, traj[-1], place_pose)
        assert res is not None
        ptraj = np.asarray(res.traj, np.float64)
        jrep = jex.execute_place(js, ptraj, place_pose, rel, sub_plan=6)
    finally:
        t.update_pose(orig_pose)
        js.detach_target()
        js.env._scene_sdf = None
    trep = execute_place(ts, ptraj, place_pose, rel, sub_plan=6)
    assert trep.reward == jrep.reward and trep.carried == jrep.carried == 1
    for f in ("place_err_xy_m", "place_err_z_m", "drop_h_m"):
        assert abs(getattr(trep, f) - getattr(jrep, f)) < 1e-3, (
            f, trep, jrep)
