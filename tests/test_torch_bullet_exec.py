"""The port's optional PyBullet harness (``apps/bullet_exec.py``) against
the JAX package's, on the recording ``FakeBullet`` double of
``tests/test_bullet_exec.py`` (pybullet is absent from this image): on the
same scene, both modules must issue the same shapes, masses, poses and
command stream, exactly.  A tensor trajectory on the port's side is copied
to the host once and drives the same commands."""

import importlib
import sys

import numpy as np
import pytest
import torch

from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.planner.scene import PlanningScene
from test_bullet_exec import FakeBullet


@pytest.fixture()
def fakes(monkeypatch):
    """(port module, JAX module, a fresh FakeBullet factory)."""
    import omg_planner_torch.apps.bullet_exec as tmod
    import omg_planner_tpu.apps.bullet_exec as jmod

    def use(mod):
        fake = FakeBullet()
        monkeypatch.setitem(sys.modules, "pybullet", fake)
        importlib.reload(mod)
        return fake

    yield tmod, jmod, use
    sys.modules.pop("pybullet", None)
    importlib.reload(tmod)         # restore the gated (no-pybullet) state
    importlib.reload(jmod)


def _record(mod, fake, scene, traj):
    env = mod.BulletExecutionEnv(scene, urdf_path="panda.urdf")
    env.execute_plan(traj)
    tname = scene.env.target.name
    fake.bodies[env.bodies[tname]]["pos"][2] = 0.5
    lifted = env.lift_reward(tname)
    env.close()
    return (fake.shapes, fake.bodies, fake.commands, fake.steps,
            env.bodies, lifted, fake.disconnected)


def test_same_calls_as_jax(fakes):
    tmod, jmod, use = fakes
    traj = np.tile(np.linspace(0, 1, 4)[:, None], (1, 9))
    jscene = JScene.synthetic(JConfig(silent=True), scene_id=0,
                              n_obstacles=2)
    tscene = PlanningScene.synthetic(OMGConfig(silent=True), scene_id=0,
                                     n_obstacles=2, device="cpu")
    fake_j = use(jmod)
    j = _record(jmod, fake_j, jscene, traj)
    fake_t = use(tmod)
    assert tmod.HAVE_PYBULLET
    t = _record(tmod, fake_t, tscene, torch.as_tensor(traj))
    assert t == j
    assert len(t[2]) == 4 * 7 and t[3] == 4 * tmod.BulletExecutionEnv.SUBSTEPS
    assert t[5] == 1.0


def test_shape_kinds_and_quaternions_match_jax(fakes):
    from omg_planner_torch.io.assets import make_primitive, pose_at
    from omg_planner_torch.utils.pose import mat_to_quat, rot_y, rot_z

    tmod, jmod, use = fakes
    objs = [make_primitive("ball", "sphere", [0.03], pose_at([0, 0, 0.1]),
                           compute_grasp=False),
            make_primitive("can", "cylinder", [0.04, 0.1],
                           pose_at([0, 0.2, 0.1], yaw=0.4),
                           compute_grasp=False),
            make_primitive("block", "box", [0.04, 0.05, 0.06],
                           pose_at([0.2, 0, 0.1], yaw=-1.1),
                           compute_grasp=False)]
    calls = []
    for mod in (jmod, tmod):
        fake = use(mod)
        env = mod.BulletExecutionEnv.__new__(mod.BulletExecutionEnv)
        for o in objs:
            env._add_primitive(o, 0.2)
        calls.append((fake.shapes, fake.bodies))
    assert calls[0] == calls[1]
    assert [s[0] for s in calls[1][0]] == [FakeBullet.GEOM_SPHERE,
                                           FakeBullet.GEOM_CYLINDER,
                                           FakeBullet.GEOM_BOX]
    r = (rot_z(torch.tensor(0.7)) @ rot_y(torch.tensor(-0.4)))[:3, :3]
    xyzw = np.asarray(tmod._mat_to_xyzw(r.double().numpy()))
    wxyz = mat_to_quat(r.float()).numpy()
    got = np.r_[xyzw[3], xyzw[:3]]
    if np.sign(got[0]) != np.sign(wxyz[0]):
        got = -got                     # q and -q are the same rotation
    np.testing.assert_allclose(got, wxyz, atol=1e-5)


def test_gated_without_pybullet():
    import omg_planner_torch.apps.bullet_exec as mod
    if mod.HAVE_PYBULLET:              # real pybullet present: nothing to gate
        pytest.skip("pybullet installed")
    with pytest.raises(ImportError, match="pybullet is not installed"):
        mod._require()
