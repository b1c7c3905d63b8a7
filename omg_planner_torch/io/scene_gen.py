"""Difficulty-calibrated scene generation with settle-and-reject
(numpy copy of ``synthetic_hard_scene``, ``random_settled_scene`` and
their helpers from ``omg_planner_tpu/io/scene_gen.py``, where the
families and the placement rules are documented; the port imports nothing
of the JAX package).

Objects are dropped onto their support surface (primitives settle
analytically) and placements are rejected when any object's surface
points penetrate another object's SDF.  Families: ``clutter`` (corridor
blockers and clutter around the target), ``shelf`` (the target inside a
five-walled shelf at arm height) and ``far`` (the target near the reach
limit).  The pinned 100-scene artifact is ``data/suite_v2/``.
"""

from __future__ import annotations

import numpy as np

from .assets import (TABLE_TOP, _OBJ_KINDS, _object_half_height,
                     make_primitive, pose_at)


def _world_points(obj, n: int = 200) -> np.ndarray:
    pts = obj.points[:n]
    return pts @ obj.pose_mat[:3, :3].T + obj.pose_mat[:3, 3]


def overlaps(obj_a, obj_b, margin: float = 0.003) -> bool:
    """SDF-overlap test: does any surface point of A penetrate B (or vice
    versa) deeper than ``-margin``?  Both directions are checked because
    point sampling is sparse."""
    for a, b in ((obj_a, obj_b), (obj_b, obj_a)):
        pts = _world_points(a)
        inv = np.linalg.inv(b.pose_mat)
        local = pts @ inv[:3, :3].T + inv[:3, 3]
        if np.any(b.sdf.get_distance(local) < -margin):
            return True
    return False


def settle_z(kind: str, extents) -> float:
    """Rest height of a primitive's center on a support plane (analytic
    settling; primitives are convex and flat-bottomed or spherical)."""
    return _object_half_height(kind, extents)


def place_settled(objects, name, kind, extents, rng, sample_xy,
                  support_z: float = TABLE_TOP, yaw=None,
                  max_tries: int = 40, target: bool = False,
                  compute_grasp: bool = False):
    """Sample a placement, settle it on the support, reject on SDF overlap
    with every existing object.  Returns the placed object or None."""
    for _ in range(max_tries):
        x, y = sample_xy(rng)
        z = support_z + settle_z(kind, extents)
        obj = make_primitive(
            name, kind, extents,
            pose_at([x, y, z],
                    rng.uniform(0, 2 * np.pi) if yaw is None else yaw),
            target=target, compute_grasp=compute_grasp)
        if not any(overlaps(obj, o) for o in objects
                   if o.name != "table" and not o.name.startswith("floor")):
            return obj
    return None


def _table(extent_y: float = 1.6):
    return make_primitive(
        "table", "box", [1.0, extent_y, 2 * TABLE_TOP],
        pose_at([0.68, 0.0, 0.0]), compute_grasp=False, delta=0.02)


def _shelf_walls(center, inner=(0.34, 0.40, 0.26), thick=0.024,
                 lip: float = 0.0, delta=0.012):
    """Five thin boxes forming a shelf whose opening faces the robot (-x),
    plus an optional front lip (height ``lip``) partially blocking the
    opening from below — reaching in must arc over it.
    ``inner`` = interior (depth, width, height)."""
    cx, cy, cz = center
    d, w, h = inner
    walls = [
        ("shelf_top", [d, w + 2 * thick, thick],
         [cx, cy, cz + h / 2 + thick / 2]),
        ("shelf_bottom", [d, w + 2 * thick, thick],
         [cx, cy, cz - h / 2 - thick / 2]),
        ("shelf_left", [d, thick, h], [cx, cy - w / 2 - thick / 2, cz]),
        ("shelf_right", [d, thick, h], [cx, cy + w / 2 + thick / 2, cz]),
        ("shelf_back", [thick, w + 2 * thick, h + 2 * thick],
         [cx + d / 2 + thick / 2, cy, cz]),
    ]
    if lip > 0:
        walls.append(("shelf_lip", [thick, w, lip],
                      [cx - d / 2 - thick / 2, cy, cz - h / 2 + lip / 2]))
    return [make_primitive(n, "box", e, pose_at(p), compute_grasp=False,
                           delta=delta) for n, e, p in walls]


def synthetic_hard_scene(scene_id: int, family: str | None = None):
    """Difficulty-calibrated scene (settle-and-reject placements).

    Returns (objects, target_name); the target is ``objects[0]`` per the
    reference scene layout convention (``omg/core.py:258-278``).
    """
    rng = np.random.default_rng(7000 + scene_id)
    fam = family or ("clutter", "shelf", "far")[scene_id % 3]
    objects = []

    if fam == "shelf":
        # shelf interior center at arm height; target inside, recessed.
        # The ceiling sits just above the target (blocks top-down grasps)
        # and a front lip blocks the bottom of the opening, so every
        # approach must thread horizontally and arc over the lip.
        # tall targets only: a horizontal grasp at mid-height must keep the
        # hand clear of the shelf plate (short objects force plate-grazing
        # grasps that no planner can make collision-free)
        tall = [k for k in _OBJ_KINDS
                if 2 * settle_z(k[1], k[2]) >= 0.10]
        tkind = tall[scene_id % len(tall)]
        t_height = 2 * settle_z(tkind[1], tkind[2])
        cy = rng.uniform(-0.22, 0.22)
        cz = TABLE_TOP + rng.uniform(0.16, 0.30)
        cx = rng.uniform(0.58, 0.66)
        inner = (0.30, 0.44, t_height + rng.uniform(0.13, 0.20))
        walls = _shelf_walls((cx, cy, cz), inner=inner,
                             lip=rng.uniform(0.02, 0.035))
        plate_z = cz - inner[2] / 2  # top face of the bottom wall

        def in_shelf(rng):
            # near the opening: recessed placements force the whole wrist
            # inside the plate clearance band, which 70 CHOMP steps cannot
            # reliably thread (probe scenes 4/13 stuck at 57-191 colliding
            # points when the target sat >10 cm deep)
            return (cx + rng.uniform(-0.13, -0.06),
                    cy + rng.uniform(-0.08, 0.08))

        target = place_settled(walls, tkind[0], tkind[1], tkind[2], rng,
                               in_shelf, support_z=plate_z, target=True,
                               compute_grasp=True)
        if target is None:
            # placement rejected on every try (tight interior draw):
            # re-roll the whole scene with a derived seed
            return synthetic_hard_scene(scene_id + 7919, family=fam)
        objects = [target] + walls
        # one distractor inside the shelf beside the target
        d = place_settled(objects, "distractor", "cylinder", [0.03, 0.12],
                          rng, in_shelf, support_z=plate_z)
        if d is not None:
            objects.append(d)
        # clutter on the table in front of the shelf
        def front(rng):
            return (rng.uniform(0.32, cx - 0.24),
                    cy + rng.uniform(-0.2, 0.2))
        c = place_settled(objects, "front_blocker", "cylinder",
                          [0.04, 0.22], rng, front)
        if c is not None:
            objects.append(c)
    else:
        far = fam == "far"
        r = rng.uniform(0.70, 0.76) if far else rng.uniform(0.48, 0.62)
        th = rng.uniform(-0.45, 0.45)
        tx, ty = r * np.cos(th), r * np.sin(th)
        tkind = _OBJ_KINDS[scene_id % len(_OBJ_KINDS)]
        target = make_primitive(
            tkind[0], tkind[1], tkind[2],
            pose_at([tx, ty, TABLE_TOP + settle_z(tkind[1], tkind[2])],
                    rng.uniform(0, 2 * np.pi)),
            target=True)
        objects = [target]
        # packing around the target with a guaranteed GAP SECTOR: neighbors
        # crowd most azimuths (goal standoffs near them need fine
        # optimization) but one corridor always stays open, so the scene is
        # feasible by construction and the learner's job is to find the
        # goal that threads the gap — the reference's dense-YCB regime
        gap = rng.uniform(0, 2 * np.pi)
        n_adj = 3
        for i in range(n_adj):
            ang = gap + np.pi / 2 + (i / max(n_adj - 1, 1)) * np.pi \
                + rng.uniform(-0.2, 0.2)
            def adjacent(rng, ang=ang):
                d = rng.uniform(0.12, 0.16)
                return (tx + d * np.cos(ang), ty + d * np.sin(ang))
            a = place_settled(objects, f"adjacent_{i}", "cylinder",
                              [rng.uniform(0.03, 0.04),
                               rng.uniform(0.10, 0.16)], rng,
                              adjacent)
            if a is not None:
                objects.append(a)
        # a wide thin WALL perpendicular to the base->target chord: every
        # straight line from the start sweep hits it (so the initial
        # spline always collides), but there is head-room to arc over —
        # the "colliding but fixable" regime where the optimizer does
        # reference-grade work instead of terminating on the init spline
        f = rng.uniform(0.50, 0.66)
        wall_h = rng.uniform(0.24, 0.30) if far else rng.uniform(0.28, 0.38)
        wall_w = rng.uniform(0.44, 0.60)
        def on_chord(rng):
            perp = rng.uniform(-0.03, 0.03)
            return (f * tx - perp * np.sin(th), f * ty + perp * np.cos(th))
        wall = place_settled(objects, "wall", "box",
                             [0.04, wall_w, wall_h], rng, on_chord,
                             yaw=th)
        if wall is not None:
            objects.append(wall)
        # plus 1-2 corridor cylinders off the chord
        for i in range(int(rng.integers(1, 3))):
            def corridor(rng, i=i):
                fc = rng.uniform(0.45, 0.85)
                perp = rng.uniform(0.07, 0.14) * (1 if i % 2 else -1)
                return (fc * tx - perp * np.sin(th),
                        fc * ty + perp * np.cos(th))
            h = rng.uniform(0.20, 0.30)
            b = place_settled(objects, f"blocker_{i}", "cylinder",
                              [0.05, h], rng, corridor)
            if b is not None:
                objects.append(b)
        # scattered clutter
        for i in range(3):
            okind = _OBJ_KINDS[(scene_id + i + 1) % len(_OBJ_KINDS)]
            def scatter(rng):
                ro = rng.uniform(0.38, 0.70)
                tho = rng.uniform(-0.65, 0.65)
                return (ro * np.cos(tho), ro * np.sin(tho))
            c = place_settled(objects, f"{okind[0]}_{i}", okind[1],
                              okind[2], rng, scatter)
            if c is not None:
                objects.append(c)

    objects.append(_table())
    return objects, objects[0].name


def random_settled_scene(seed: int, n_obstacles: int = 4):
    """Unbounded randomized generator (reference
    ``panda_scene.py:308-405`` role): uniform placements with analytic
    settling + SDF-overlap rejection; target first."""
    rng = np.random.default_rng(seed)
    tkind = _OBJ_KINDS[int(rng.integers(len(_OBJ_KINDS)))]

    def anywhere(rng):
        ro = rng.uniform(0.40, 0.70)
        tho = rng.uniform(-0.6, 0.6)
        return (ro * np.cos(tho), ro * np.sin(tho))

    target = place_settled([], tkind[0], tkind[1], tkind[2], rng, anywhere,
                           target=True, compute_grasp=True)
    objects = [target]
    for i in range(n_obstacles):
        okind = _OBJ_KINDS[int(rng.integers(len(_OBJ_KINDS)))]
        o = place_settled(objects, f"{okind[0]}_{i}", okind[1], okind[2],
                          rng, anywhere)
        if o is not None:
            objects.append(o)
    objects.append(_table())
    return objects, objects[0].name
