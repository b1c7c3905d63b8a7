"""Scripted multi-step pick-and-place (kitchen) tasks (counterpart of
``omg_planner_tpu/apps/kitchen.py``).

Re-implements the reference's kitchen task runner
(``bullet/panda_kitchen_scene.py:440-607`` + ``real_world/trial.py:235-430``)
without PyBullet/GL: a synthetic cabinet scene and the same script grammar
(parsed at ``panda_kitchen_scene.py:477-501``):

    T <target_name>          plan a grasp of <target_name>
    P dx,dy,dz[,standoff]    place the held object displaced by (dx,dy,dz)
    E <i>                    move to anchor configuration i
    ONCE                     run the script once (no looping)

Usage:  python -m omg_planner_torch.apps.kitchen -s script.txt [--exec]
[--exec-retries N] [--fast] [--cpu]

Planning and the ``--exec`` rollouts run on ``cuda`` (each scored step one
launch of the ``rigid_rollout`` kernel) unless ``--cpu`` is given.

Verdict semantics: P and post-place E steps start with the hand wrapped
around an object resting on its support, so some collision points count
by construction (measured: the stay-at-start "plan" alone counts 104)
— the reference returns BOTH best-effort without checking any verdict
(``trial.py:36-66,123-131``, with cabinet fixtures hard-disabled).  We
print the strict verdict anyway; ``--exec`` adds the rigid-body physics
outcome (:mod:`omg_planner_torch.physics`), which is the meaningful judge
for these steps — e.g. the demo's place reads "plan FAIL" yet places
within 18 mm in-sim.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import OMGConfig
from ..io.assets import DEFAULT_START, make_primitive, pose_at
from ..planner import tasks
from ..planner.goal_set import ANCHOR_SEEDS
from ..planner.scene import Env, PlanningScene


def kitchen_scene(cfg: OMGConfig, device=None) -> PlanningScene:
    """A synthetic cabinet: shelf boards + side walls + objects on shelves
    (plays the role of ``data/scenes/kitchen0.mat``), on ``device``
    (``cuda`` unless the caller names another)."""
    env = Env(cfg, device=device)
    # shelf boards
    for k, z in enumerate((0.05, 0.42)):
        env.add_object(make_primitive(
            f"shelf_{k}", "box", [0.5, 0.9, 0.04],
            pose_at([0.62, 0.0, z]), compute_grasp=False, delta=0.02))
    # side walls
    for k, y in enumerate((-0.47, 0.47)):
        env.add_object(make_primitive(
            f"wall_{k}", "box", [0.5, 0.04, 0.8],
            pose_at([0.62, y, 0.4]), compute_grasp=False, delta=0.02))
    # objects on the lower shelf
    env.add_object(make_primitive(
        "mug", "cylinder", [0.032, 0.1], pose_at([0.52, -0.18, 0.12])))
    env.add_object(make_primitive(
        "can", "cylinder", [0.030, 0.12], pose_at([0.55, 0.15, 0.13])))
    env.set_target("mug")
    return PlanningScene(cfg, env)


def parse_script(path: str):
    steps = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line == "ONCE":
                steps.append(("ONCE",))
            elif line.startswith("T "):
                steps.append(("T", line[2:].strip()))
            elif line.startswith("P "):
                vals = [float(v) for v in line[2:].split(",")]
                steps.append(("P", vals))
            elif line.startswith("E "):
                steps.append(("E", int(line[2:])))
    return steps


def run_script(scene: PlanningScene, steps, fast: bool = False,
               execute: bool = False, exec_retries: int = 0):
    """Execute the parsed script; returns the per-step results.

    ``execute=True`` additionally scores each pick/place step in the
    rigid-body stepper (:mod:`omg_planner_torch.physics`) — the role
    of the reference's continuous PyBullet kitchen world
    (``panda_kitchen_scene.py:440-607``).  Each step is simulated from
    its planned scene state (the script's world model advances
    kinematically between steps, as in the reference's replanning loop);
    returns ``(results, exec_reports)`` where ``exec_reports[i]`` is the
    step's PhysExecReport / PlaceExecReport dict.

    ``exec_retries`` > 0 makes PICK steps execution-verified
    (``planner/exec_verify.py``): a pick whose simulated lift fails
    re-plans with the failed goal's neighborhood blacklisted, so the
    script continues from a grasp that actually holds.  ``conf`` stays a
    host array between steps."""
    conf = np.array(DEFAULT_START)
    held = None
    results = []
    reports: dict[int, dict] = {}
    for step in steps:
        kind = step[0]
        if kind == "ONCE":
            continue
        if kind == "T":
            if execute and exec_retries > 0:
                # execution-verified pick: the task staging is exactly
                # plan_to_target's (set target + start), then the
                # simulate-blacklist-replan loop picks a holding grasp
                from ..planner.exec_verify import plan_execute_verified

                scene.env.set_target(step[1])
                scene.start = np.asarray(conf)
                out = plan_execute_verified(
                    scene, exec_retries=exec_retries, fast=fast,
                    lift_height=0.1)
                res = out.result if out is not None else None
                if out is not None and out.report is not None:
                    reports[len(results)] = dict(
                        out.report.to_dict(), verified=out.verified,
                        exec_attempts=out.exec_attempts)
            else:
                res = tasks.plan_to_target(scene, conf, step[1],
                                           fast=fast)
                if res is not None and execute:
                    from ..physics import execute_plan
                    rep = execute_plan(scene, np.asarray(res.traj),
                                       lift_height=0.1)
                    reports[len(results)] = rep.to_dict()
            if res is not None:
                conf = np.asarray(res.traj[-1])
                held = step[1]
            results.append(("pick", step[1], res))
        elif kind == "P":
            if held is None:
                results.append(("place", None, None))
                continue
            dx, dy, dz = step[1][:3]
            # optional 4th value: standoff placement (script grammar
            # ``P dx,dy,dz,standoff``, panda_kitchen_scene.py:477-501)
            standoff = bool(step[1][3]) if len(step[1]) > 3 else False
            place = scene.env.target.pose_mat.copy()
            place[:3, 3] += [dx, dy, dz]
            rel = None
            if execute:
                scene.env.set_target(held)
                scene.attach_target(np.asarray(conf))
                rel = scene.env.target.rel_hand_pose.copy()
            res, achieved = tasks.place_target(scene, conf, place,
                                               target_name=held,
                                               apply_standoff=standoff,
                                               fast=fast)
            if res is not None:
                conf = np.asarray(res.traj[-1])
                if execute:
                    from ..physics import execute_place
                    rep = execute_place(scene, np.asarray(res.traj),
                                        place, rel)
                    reports[len(results)] = rep.to_dict()
            held = None
            results.append(("place", achieved, res))
        elif kind == "E":
            target_conf = ANCHOR_SEEDS[step[1] % len(ANCHOR_SEEDS)]
            res = tasks.plan_to_conf(scene, conf, target_conf, fast=fast)
            if res is not None:
                conf = np.asarray(res.traj[-1])
            results.append(("move", step[1], res))
    if execute:
        return results, reports
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-s", "--script", default=None)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="plan and execute on the CPU instead of cuda")
    ap.add_argument("--exec", dest="execute", action="store_true",
                    help="score each pick/place step in the rigid-body "
                         "physics stepper")
    ap.add_argument("--exec-retries", type=int, default=0,
                    help="execution-verified picks: a failed simulated "
                         "lift blacklists the goal and re-plans")
    args = ap.parse_args(argv)
    from .. import resolve_device

    cfg = OMGConfig(silent=False)
    scene = kitchen_scene(cfg, resolve_device("cpu" if args.cpu else None))
    if args.script:
        steps = parse_script(args.script)
    else:  # default demo: pick the mug, move it 20 cm sideways, retreat
        steps = [("T", "mug"), ("P", [0.0, 0.25, 0.0]), ("E", 0)]
    reports = {}
    if args.execute:
        results, reports = run_script(scene, steps, fast=args.fast,
                                      execute=True,
                                      exec_retries=args.exec_retries)
    else:
        results = run_script(scene, steps, fast=args.fast)
    for i, (kind, what, res) in enumerate(results):
        ok = res is not None and bool(res.flag)
        line = f"{kind}: {'OK' if ok else 'FAIL'}"
        if i in reports:
            r = reports[i]
            line += (f"  [sim reward {r['reward']}"
                     + (f", lifted {r['lifted_m']:.3f} m"
                        if "lifted_m" in r else
                        f", place err {r['place_err_xy_m']*1000:.0f} mm")
                     + "]")
        print(line)
    return results, reports


if __name__ == "__main__":
    main()
