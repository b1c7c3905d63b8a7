"""The port's rigid-body stepper (``omg_planner_torch/physics/rigid.py``)
against the JAX package's on the CPU, on the same numpy inputs.

Tolerances, and why:
* builders: 1e-6 (the same numpy code; float32 storage);
* contact generation and the contact solve on one seeded state: 1e-5 (one
  substep of float32 arithmetic in another op order; identical
  ``Contacts`` go to both solvers), the compacted candidate indices equal,
  ties on a box face included;
* rollouts: free fall over 120 substeps 1e-5, the resting cube over 240
  substeps 1e-4 (contacts and the Jacobi loop accumulate rounding);
* the friction-cone and damping checks of ``tests/test_physics.py`` with
  their own bars.
The kernel itself runs only on the card: the ``gpu`` test holds it against
``rollout_plain`` there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omg_planner_tpu.physics import rigid as jr
from omg_planner_torch import interop
from omg_planner_torch.ops import kernels
from omg_planner_torch.physics import rigid as tr

torch.set_num_threads(2)
CPU = "cpu"


def _np(x):
    return jax.tree.map(np.asarray, x)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _cube(mod, half=0.03, **kw):
    return mod.body_spec_from_primitive(0, np.asarray([half] * 3, np.float32),
                                        None, density=300.0, **kw)


def _world_np(z=0.0, theta=0.0, active=True):
    """A thick slab (top face through (0, 0, z), rotated ``theta`` about
    +y) and a small box obstacle."""
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    slab = np.eye(4)
    slab[:3, :3] = rot
    slab[:3, 3] = rot @ np.array([0.0, 0.0, -0.5]) + [0.0, 0.0, z]
    box = np.eye(4)
    box[:3, 3] = [0.2, 0.0, 0.05]
    return dict(
        kinds=np.asarray([0, 0], np.int32),
        halfs=np.asarray([[1.0, 1.0, 0.5], [0.05, 0.05, 0.05]], np.float32),
        rounds=np.asarray([0.0, 0.01], np.float32),
        inv_poses=np.stack([np.linalg.inv(slab), np.linalg.inv(box)]
                           ).astype(np.float32),
        mask=np.asarray([1.0 if active else 0.0, 1.0], np.float32)), rot


def _worlds(**kw):
    w, rot = _world_np(**kw)
    return (jr.StaticWorld(**{k: jnp.asarray(v) for k, v in w.items()}),
            tr.StaticWorld(**{k: torch.as_tensor(v) for k, v in w.items()}),
            rot)


def _state_np(x, q=(1.0, 0.0, 0.0, 0.0), v=(0.0, 0.0, 0.0),
              w=(0.0, 0.0, 0.0)):
    return dict(x=np.asarray(x, np.float32), q=np.asarray(q, np.float32),
                v=np.asarray(v, np.float32), w=np.asarray(w, np.float32))


def _free_track(n, k=4):
    return np.full((n + 1, k, 3), 50.0, np.float32)


class _Field:
    """A data-backed SDF: a voxelised box (inside values x5, as the mesh
    pipeline penalises them)."""

    def __init__(self, half=(0.03, 0.04, 0.05), delta=0.01, pad=3):
        self.delta = delta
        n = [int(np.ceil(2 * h / delta)) + 2 * pad for h in half]
        self.origin = -np.asarray(n) * delta / 2.0
        ax = [self.origin[i] + (np.arange(n[i]) + 0.5) * delta
              for i in range(3)]
        p = np.stack(np.meshgrid(*ax, indexing="ij"), -1)
        q = np.abs(p) - np.asarray(half)
        d = (np.linalg.norm(np.maximum(q, 0), axis=-1)
             + np.minimum(q.max(-1), 0))
        self.data = np.where(d < 0, 5.0 * d, d).astype(np.float32)


def test_builders_match_jax():
    for kind, half in ((0, [0.03, 0.04, 0.05]), (1, [0.04, 0.04, 0.04]),
                       (2, [0.035, 0.035, 0.06])):
        js = _np(jr.body_spec_from_primitive(kind, np.asarray(half)))
        ts = tr.body_spec_from_primitive(kind, np.asarray(half), device=CPU)
        for f in jr.RigidBodySpec._fields:
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       getattr(js, f), rtol=1e-6, atol=1e-6,
                                       err_msg=f"kind {kind} {f}")
    np.testing.assert_allclose(tr.box_face_grid([0.01, 0.02, 0.03], 4),
                               jr.box_face_grid([0.01, 0.02, 0.03], 4))
    field = _Field()
    for a, b in zip(tr.bake_grid_sdf(field, 5.0), jr.bake_grid_sdf(field, 5.0)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    pts = np.random.default_rng(0).uniform(-0.05, 0.05, (150, 3))
    js = _np(jr.body_spec_from_grid(field, pts))
    ts = tr.body_spec_from_grid(field, pts, device=CPU)
    for f in jr.RigidBodySpec._fields:
        np.testing.assert_allclose(getattr(ts, f).numpy(), getattr(js, f),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    empty = _Field()
    empty.data = np.abs(empty.data) + 0.01
    with pytest.raises(tr.NoMassModelError):
        tr.body_spec_from_grid(empty, pts, device=CPU)


def _same_contacts(jc, tc, what):
    jc = _np(jc)
    for f in jr.Contacts._fields:
        a, b = getattr(jc, f), getattr(tc, f)[0].numpy()
        if f == "src":
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=f"{what} {f}")


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0], [0, 0, 1]])


def _seeded_scene():
    """A tilted box body pressed into the slab, robot spheres around it,
    two finger pads pressing its +-y faces, tilted against them so that
    every candidate's depth is distinct (near-ties are ordered by last-bit
    rounding, which differs between XLA and torch; exact ties are
    ``test_topk_ties_on_a_box_face``)."""
    rng = np.random.default_rng(1)
    spec_j = jr.body_spec_from_primitive(0, np.asarray([0.03, 0.02, 0.04]))
    spec_t = tr.body_spec_from_primitive(0, np.asarray([0.03, 0.02, 0.04]),
                                         device=CPU)
    ang = 0.3
    qz = np.array([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)])
    qx = np.array([np.cos(0.025), np.sin(0.025), 0.0, 0.0])   # 0.05 rad
    q = [qz[0] * qx[0], qz[0] * qx[1], qz[3] * qx[1], qz[3] * qx[0]]
    st = _state_np(x=[0.01, -0.02, 0.0385], q=q, v=[0.01, 0.0, -0.02],
                   w=[0.1, -0.2, 0.05])
    sph = (st["x"] + rng.uniform(-0.05, 0.05, (60, 3))).astype(np.float32)
    sph_v = rng.normal(scale=0.05, size=(60, 3)).astype(np.float32)
    is_finger = (np.arange(60) >= 50).astype(np.float32)
    r = np.asarray(jr.quat_to_mat(jnp.asarray(q, jnp.float32)))
    pads = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    for f, sgn in enumerate((1.0, -1.0)):
        pads[f, :3, :3] = r @ _rx(0.1 * sgn) @ _rz(0.07)
        pads[f, :3, 3] = st["x"] + r @ np.array([0.0, sgn * 0.0245, 0.0])
    pads_next = pads.copy()
    pads_next[:, :3, 3] += np.array([0.0, 0.0, 1e-4], np.float32)
    pad_samples = np.stack([jr.box_face_grid([0.01, 0.005, 0.01], 4)] * 2
                           ).astype(np.float32)
    return spec_j, spec_t, st, sph, sph_v, is_finger, pads, pads_next, \
        pad_samples


def test_contacts_and_solve_match_jax():
    (spec_j, spec_t, st, sph, sph_v, is_finger, pads, pads_next,
     pad_samples) = _seeded_scene()
    jw, tw, _ = _worlds()
    pp_j = jr.default_params()
    pp_t = tr.default_params(device=CPU)
    js = jr.BodyState(**{k: jnp.asarray(v) for k, v in st.items()})
    ts = tr.BodyState(**{k: _t(v)[None] for k, v in st.items()})
    jrc = jr._robot_contacts(spec_j, js, jnp.asarray(sph), jnp.asarray(sph_v),
                             jnp.asarray(is_finger), pp_j.sphere_radius, 48)
    trc = tr._robot_contacts(spec_t, ts, _t(sph)[None], _t(sph_v)[None],
                             _t(is_finger), pp_t.sphere_radius, 48)
    _same_contacts(jrc, trc, "robot")
    assert 0 < float(trc.active.sum()) < 48
    jpc = jr._pad_contacts(spec_j, js, jnp.asarray(pads),
                           jnp.asarray(pads_next), jnp.asarray(pad_samples),
                           pp_j.dt, 32)
    tpc = tr._pad_contacts(spec_t, ts, _t(pads)[None], _t(pads_next)[None],
                           _t(pad_samples), pp_t.dt, 32)
    _same_contacts(jpc, tpc, "pad")
    assert float(tpc.active.sum()) == 32   # more candidates than lanes
    np.testing.assert_allclose(
        tr._pad_probe_pen(spec_t, ts, _t(pads)[None], _t(pad_samples))[0],
        np.asarray(jr._pad_probe_pen(spec_j, js, jnp.asarray(pads),
                                     jnp.asarray(pad_samples))), atol=1e-6)
    jwc = jr._world_contacts(spec_j, jw, js, 48)
    twc = tr._world_contacts(spec_t, tw, ts, 48)
    _same_contacts(jwc, twc, "world")
    assert float(twc.active.sum()) > 0

    # the solver on identical contacts and warm starts
    jc = jr.Contacts(*[jnp.concatenate(f) for f in zip(jrc, jpc, jwc)])
    tc = tr.Contacts(*[torch.as_tensor(np.asarray(a))[None]
                       for a in _np(jc)])
    rng = np.random.default_rng(2)
    n_c = jc.pen.shape[0]
    warm = [rng.uniform(0.0, 0.02, n_c).astype(np.float32),
            rng.normal(scale=0.005, size=n_c).astype(np.float32),
            rng.normal(scale=0.005, size=n_c).astype(np.float32)]
    for iters in (48, 96):
        for w in (None, warm):
            jo = jr._solve_contacts(spec_j, js, jc, pp_j, iters,
                                    None if w is None else
                                    tuple(jnp.asarray(a) for a in w))
            to = tr._solve_contacts(spec_t, ts, tc, pp_t, iters,
                                    None if w is None else
                                    tuple(_t(a)[None] for a in w))
            jo = _np(jo)
            for name, a, b in (("v", jo[0], to[0]), ("w", jo[1], to[1]),
                               ("pv", jo[3], to[3]), ("pw", jo[4], to[4])):
                np.testing.assert_allclose(b[0].numpy(), a, atol=1e-5,
                                           err_msg=name)
            for i in range(3):
                np.testing.assert_allclose(to[2][i][0].numpy(), jo[2][i],
                                           atol=1e-5, err_msg=f"lam {i}")


def test_topk_ties_on_a_box_face():
    """Every sample of a pad's face grid against a flat box face has the
    same penetration: whole groups tie, and the compacted lanes must be
    jax.lax.top_k's (lower index first)."""
    spec_j = jr.body_spec_from_primitive(0, np.asarray([0.05] * 3))
    spec_t = tr.body_spec_from_primitive(0, np.asarray([0.05] * 3),
                                         device=CPU)
    st = _state_np(x=[0.0, 0.0, 0.0])
    js = jr.BodyState(**{k: jnp.asarray(v) for k, v in st.items()})
    ts = tr.BodyState(**{k: _t(v)[None] for k, v in st.items()})
    pads = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    pads[0, :3, 3] = [0.0, 0.05, 0.0]      # face grids centred on the body
    pads[1, :3, 3] = [0.0, -0.05, 0.0]     # faces +-y: many equal phis
    pad_samples = np.stack([jr.box_face_grid([0.01, 0.002, 0.01], 4)] * 2
                           ).astype(np.float32)
    jpc = jr._pad_contacts(spec_j, js, jnp.asarray(pads), jnp.asarray(pads),
                           jnp.asarray(pad_samples), 1.0 / 240.0, 32)
    tpc = tr._pad_contacts(spec_t, ts, _t(pads)[None], _t(pads)[None],
                           _t(pad_samples), 1.0 / 240.0, 32)
    pen = np.asarray(jpc.pen)
    assert len(np.unique(pen[np.asarray(jpc.active) > 0])) < 8   # ties
    _same_contacts(jpc, tpc, "pad ties")


def _rollout_pair(spec_j, spec_t, jw, tw, pp_j, pp_t, st, track, **kw):
    js = jr.BodyState(**{k: jnp.asarray(v) for k, v in st.items()})
    ts = tr.BodyState(**{k: _t(v) for k, v in st.items()})
    jf, jt = jr.rollout(spec_j, jw, pp_j, js, jnp.asarray(track), **kw)
    tf, tt = tr.rollout(spec_t, tw, pp_t, ts, _t(track), **kw)
    return _np(jf), _np(jt), tf, tt


def test_free_fall_matches_jax():
    jw, tw, _ = _worlds(active=False)
    jw = jw._replace(mask=jnp.zeros(2))
    tw = tw._replace(mask=torch.zeros(2))
    pp_j = jr.default_params()._replace(damp_lin=jnp.asarray(0.0))
    pp_t = tr.default_params(device=CPU)._replace(damp_lin=torch.tensor(0.0))
    st = _state_np(x=[0.0, 0.0, 1.0])
    jf, jt, tf, tt = _rollout_pair(_cube(jr), _cube(tr, device=CPU), jw, tw,
                                   pp_j, pp_t, st, _free_track(120))
    for k in ("x", "v", "q", "w"):
        np.testing.assert_allclose(tt[k].numpy(), jt[k], atol=1e-5,
                                   err_msg=k)
    n, dt = 120, float(pp_t.dt)
    expect = 1.0 - 9.81 * dt ** 2 * n * (n + 1) / 2.0
    assert abs(float(tf.x[2]) - expect) < 1e-3
    assert float(tt["world_contacts"].sum()) == 0.0


def test_resting_cube_matches_jax():
    jw, tw, _ = _worlds()
    pp_j, pp_t = jr.default_params(), tr.default_params(device=CPU)
    st = _state_np(x=[0.0, 0.0, 0.031])
    jf, jt, tf, tt = _rollout_pair(_cube(jr), _cube(tr, device=CPU), jw, tw,
                                   pp_j, pp_t, st, _free_track(240))
    for k in ("x", "v", "q", "w"):
        np.testing.assert_allclose(tt[k].numpy(), jt[k], atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(tt["world_contacts"].numpy(),
                                  jt["world_contacts"])
    assert abs(float(tf.x[2]) - 0.030) < 2e-3
    assert float(tt["x"][120:, :2].abs().max()) < 1e-3


def test_batch_equals_single_rollouts():
    jw, tw, _ = _worlds()
    spec, pp = _cube(tr, device=CPU), tr.default_params(device=CPU)
    st = tr.BodyState(x=_t([[0.0, 0.0, 0.035], [0.1, 0.0, 0.2]]),
                      q=_t([[1.0, 0.0, 0.0, 0.0]] * 2), v=torch.zeros(2, 3),
                      w=torch.zeros(2, 3))
    tracks = _t(np.stack([_free_track(60), _free_track(60) + 1.0]))
    bf, bt = tr.rollout(spec, tw, pp, st, tracks)
    for i in range(2):
        one_f, one_t = tr.rollout(spec, tw, pp,
                                  tr.BodyState(*(a[i] for a in st)),
                                  tracks[i])
        for k in ("x", "v", "q", "w"):
            np.testing.assert_allclose(bt[k][i].numpy(), one_t[k].numpy(),
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(bf.x[i].numpy(), one_f.x.numpy(),
                                   atol=1e-6)


def _incline_slide(theta_deg: float, mu: float = 0.8) -> float:
    theta = np.radians(theta_deg)
    _, tw, rot = _worlds(theta=theta)
    tw = tw._replace(mask=torch.tensor([1.0, 0.0]))
    x0 = rot @ np.array([0.0, 0.0, 0.0305])
    st = tr.BodyState(x=_t(x0), q=_t([np.cos(theta / 2), 0.0,
                                      np.sin(theta / 2), 0.0]),
                      v=torch.zeros(3), w=torch.zeros(3))
    pp = tr.default_params(device=CPU)._replace(
        mu=torch.tensor(mu), damp_lin=torch.tensor(0.0),
        damp_ang=torch.tensor(0.0))
    final, _ = tr.rollout(_cube(tr, device=CPU), tw, pp, st,
                          _t(_free_track(120)))
    downhill = rot @ np.array([1.0, 0.0, 0.0])
    return float((final.x.numpy() - x0) @ downhill)


def test_friction_cone_stick_slip_threshold():
    """tests/test_physics.py's closed-form oracle: mu = 0.8 sticks at 25
    degrees and slides at 55."""
    stick = _incline_slide(25.0)
    slip = _incline_slide(55.0)
    assert abs(stick) < 5e-3, stick
    assert slip > 0.05, slip
    assert slip > 10 * max(abs(stick), 1e-4)


def test_damping_energy_decay_matches_exponential():
    _, tw, _ = _worlds()
    tw = tw._replace(mask=torch.zeros(2))
    c = 2.0
    pp = tr.default_params(device=CPU)._replace(
        damp_lin=torch.tensor(c), gravity=torch.zeros(3))
    v0 = np.array([0.4, -0.2, 0.3], np.float32)
    st = tr.BodyState(x=_t([0.0, 0.0, 5.0]), q=_t([1.0, 0.0, 0.0, 0.0]),
                      v=_t(v0), w=torch.zeros(3))
    final, _ = tr.rollout(_cube(tr, device=CPU), tw, pp, st,
                          _t(_free_track(240)))
    got = final.v.numpy()
    np.testing.assert_allclose(got, v0 * np.exp(-c * 240 * float(pp.dt)),
                               rtol=5e-3, atol=1e-5)


def test_grid_collider_supports_body_like_jax():
    """A baked-grid static (the data-backed obstacle path) holds the cube
    up, in both packages, within 1e-4 over 120 substeps."""
    field = _Field(half=(0.25, 0.25, 0.04), delta=0.01)
    _, grid4, lim = jr.bake_grid_sdf(field, 5.0)
    slab = np.eye(4)
    slab[2, 3] = -0.04
    w = dict(kinds=np.asarray([0], np.int32),
             halfs=np.ones((1, 3), np.float32),
             rounds=np.zeros(1, np.float32),
             inv_poses=np.eye(4, dtype=np.float32)[None],
             mask=np.zeros(1, np.float32),
             grid4=grid4[None].astype(np.float32),
             grid_limits=lim[None].astype(np.float32),
             grid_inv_poses=np.linalg.inv(slab)[None].astype(np.float32))
    jw = jr.StaticWorld(**{k: jnp.asarray(v) for k, v in w.items()})
    tw = interop.static_world(jw, CPU)
    st = _state_np(x=[0.0, 0.0, 0.035])
    jf, jt, tf, tt = _rollout_pair(
        _cube(jr), _cube(tr, device=CPU), jw, tw, jr.default_params(),
        tr.default_params(device=CPU), st, _free_track(120))
    np.testing.assert_allclose(tt["x"].numpy(), jt["x"], atol=1e-4)
    assert abs(float(tf.x[2]) - 0.030) < 4e-3


def test_interop_carries_jax_containers():
    spec = _np(_cube(jr))
    t_spec = interop.rigid_body_spec(spec, CPU)
    assert t_spec.kind.dtype == torch.int32
    np.testing.assert_array_equal(t_spec.surf.numpy(), spec.surf)
    pp = interop.phys_params(_np(jr.default_params()), CPU)
    assert float(pp.stall_pen) == pytest.approx(3.5e-3)
    jw, _, _ = _worlds()
    tw = interop.static_world(_np(jw), CPU)
    assert tw.grid4 is None and tw.kinds.dtype == torch.int32
    st = interop.body_state(_np(jr.BodyState(
        x=jnp.ones(3), q=jnp.asarray([1.0, 0, 0, 0]), v=jnp.zeros(3),
        w=jnp.zeros(3))), CPU)
    assert st.x.tolist() == [1.0, 1.0, 1.0]


def test_cpu_rollout_takes_the_plain_version_and_packs_the_kernel_args():
    """On the CPU ``rollout`` runs the plain loop (no launch); the kernel
    wrapper refuses CPU tensors; its argument packing (shapes, lane
    counts) is checked here, where it runs without a card."""
    _, tw, _ = _worlds()
    spec, pp = _cube(tr, device=CPU), tr.default_params(device=CPU)
    st = tr.BodyState(x=_t([0.0, 0.0, 0.031]), q=_t([1.0, 0, 0, 0]),
                      v=torch.zeros(3), w=torch.zeros(3))
    before = kernels.rigid_rollout.launches
    tr.rollout(spec, tw, pp, st, _t(_free_track(3)))
    assert kernels.rigid_rollout.launches == before
    args, single = tr._defaults(st, _t(_free_track(3)), None, None, None,
                                None, None, None)
    assert single
    with pytest.raises(ValueError, match="cuda"):
        kernels.rigid_rollout(spec, tw, pp, *args)
    keep, out_state, out_trace, ptrs, dims = kernels._rigid_rollout_pack(
        spec, tw, pp, *args, 48, 32, 48, 96)
    assert list(dims) == [1, 3, 4, 1, 96, 2, 0, 0, 0, 4, 2, 48, 96]
    assert out_state.shape == (1, 13) and out_trace.shape == (1, 3, 19)
    assert len(keep) == 21 and keep[8].shape == (14,)    # PhysParams
    np.testing.assert_allclose(keep[9][:5].numpy(),
                               [0.0, 0.03, 0.03, 0.03, 0.004])  # body
    bad = args[1][..., :2]
    with pytest.raises(ValueError, match="sph_track"):
        kernels._rigid_rollout_pack(spec, tw, pp, args[0], bad, *args[2:],
                                    48, 32, 48, 96)


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    """The rollout kernel against ``rollout_plain`` on the card: a resting
    cube and a batch of two (1e-5), and the grid collider (1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rollout kernel has no CPU form")
    dev = "cuda"
    w, _ = _world_np()
    tw = tr.StaticWorld(**{k: torch.as_tensor(v, device=dev)
                           for k, v in w.items()})
    spec, pp = _cube(tr, device=dev), tr.default_params(device=dev)
    st = tr.BodyState(x=torch.tensor([[0.0, 0.0, 0.031], [0.1, 0.0, 0.2]],
                                     device=dev),
                      q=torch.tensor([[1.0, 0, 0, 0]] * 2, device=dev),
                      v=torch.zeros(2, 3, device=dev),
                      w=torch.zeros(2, 3, device=dev))
    track = torch.as_tensor(np.stack([_free_track(120)] * 2), device=dev)
    before = kernels.rigid_rollout.launches
    kf, kt = tr.rollout(spec, tw, pp, st, track)
    torch.cuda.synchronize()
    assert kernels.rigid_rollout.launches == before + 1
    pf, pt = tr.rollout_plain(spec, tw, pp, st, track)
    for k in ("x", "v", "q", "w"):
        assert float((kt[k] - pt[k]).abs().max()) < 1e-5, k
    assert torch.equal(kt["world_contacts"], pt["world_contacts"])
