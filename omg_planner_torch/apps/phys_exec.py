"""Plan-and-execute over a scene suite in the rigid-body stepper
(counterpart of ``omg_planner_tpu/apps/phys_exec.py``).

The reference's evaluation loop plans each scene and executes the plan in
PyBullet, scoring the binary lift reward (``bullet/panda_scene.py``
reset/step/retract/``_reward``, driven by ``omg/core.py:869-885``).  This
app is that loop on the port: plan with the production config, replay +
close + retract in the stepper, score.  It runs on ``cuda`` (each
execution one launch of the ``rigid_rollout`` kernel) unless ``--cpu`` is
given, and raises without a GPU.

Usage::

    python -m omg_planner_torch.apps.phys_exec --scenes 30 \\
        --out phys_exec.json [--cpu] [--pipeline] [--cascade] \\
        [--exec-retries N] [--video replay.avi]

Prints one JSON line of aggregates (plan success rate, execution reward
on planned successes, end-to-end reward) and writes the full report with
per-scene rows to ``--out``.  Scenes whose plan failed are not executed
and count 0.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

SUITE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "..", "..", "data", "suite_v2")


def _write_replay(scene, trace, args):
    """Render the rollout trace (robot + simulated target) to a video."""
    from omg_planner_torch.physics.executor import _body_spec_for
    from omg_planner_torch.viz.render import render_execution, write_video

    env = scene.env
    spec = _body_spec_for(env.target, args.density, scene.cfg, scene.device)
    frames = render_execution(
        scene.model, env.objects, env.target_idx, trace["configs"],
        trace["x"], trace["q"], com=spec.com.cpu().numpy())
    write_video(frames, args.video)
    print(f"replay -> {args.video} ({len(frames)} frames)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", default=os.path.abspath(SUITE))
    ap.add_argument("--scenes", type=int, default=30)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="plan and execute on the CPU instead of cuda")
    ap.add_argument("--density", type=float, default=300.0)
    ap.add_argument("--pinch", type=float, default=0.0,
                    help="finger motor stall force override, N (0 = model "
                         "default)")
    ap.add_argument("--cascade", action="store_true",
                    help="recover plan failures with the escalation cascade "
                         "before executing")
    ap.add_argument("--exec-retries", type=int, default=0,
                    help="execution-verified planning: on a failed simulated "
                         "lift, blacklist the goal's neighbourhood and "
                         "re-plan, up to N times (0: execute the first plan "
                         "once)")
    ap.add_argument("--pipeline", action="store_true",
                    help="plans stream through the pipelined runner while a "
                         "worker thread executes rollouts; failures are "
                         "retried serially afterwards")
    ap.add_argument("--video", default="",
                    help="write an execution-replay video (robot + "
                         "simulated target pose) of the first executed "
                         "scene to this path (serial mode without "
                         "exec-retries only)")
    args = ap.parse_args(argv)

    from omg_planner_torch import resolve_device
    from omg_planner_torch.apps.serve import _device_label
    from omg_planner_torch.config import OMGConfig
    from omg_planner_torch.planner.scene import PlanningScene

    device = resolve_device("cpu" if args.cpu else None)
    cfg = OMGConfig(silent=True)          # production defaults
    pad = 0
    scenes = []
    for sid in range(args.scenes):
        path = os.path.join(args.suite, f"scene_{sid}.npz")
        scene = PlanningScene.from_npz(cfg, path, device=device)
        scenes.append((sid, scene))
        pad = max(pad, len(scene.env.objects) - 1)

    t_all = time.time()
    if args.video and (args.pipeline or args.exec_retries > 0):
        print("note: --video records only in the serial "
              "non-exec-retries mode; flag ignored for this run",
              flush=True)
    if args.pipeline:
        rows = _run_pipelined(args, cfg, scenes, pad, device)
    else:
        rows = _run_serial(args, scenes, pad, device)

    planned = [r for r in rows if r.get("plan_flag")]
    executed = [r for r in rows if r.get("executed")]
    report = {
        "what": ("plan (production cfg) + rigid-body execution + lift "
                 "reward over the pinned hard suite"),
        "device": _device_label(device),
        "n_scenes": len(rows),
        "n_exec_skipped": len(planned) - len(executed),
        "plan_success_rate": round(len(planned) / max(len(rows), 1), 3),
        "exec_reward_rate_on_planned": round(
            sum(r["reward"] for r in executed) / max(len(planned), 1), 3),
        "exec_reward_rate_on_executed": round(
            sum(r["reward"] for r in executed) / max(len(executed), 1), 3),
        "end_to_end_reward_rate": round(
            sum(r.get("reward", 0) for r in rows) / max(len(rows), 1), 3),
        "mean_lifted_m_on_success": round(float(np.mean(
            [r["lifted_m"] for r in executed if r["reward"]] or [0.0])), 3),
        "wall_s": round(time.time() - t_all, 1),
        "pipelined": bool(args.pipeline),
        "scenes": rows,
    }
    print(json.dumps({k: v for k, v in report.items() if k != "scenes"}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"-> {args.out}", flush=True)
    return report


def _pinch_params(args, device):
    """The solver constants with the ``--pinch`` override, or None (the
    executor's defaults)."""
    if args.pinch <= 0:
        return None
    from omg_planner_torch.physics import rigid

    pp = rigid.default_params(device=device)
    return pp._replace(pinch_force=pp.pinch_force.new_tensor(args.pinch))


def _run_pipelined(args, cfg, scenes, pad, device):
    """Plans stream through ``plan_pipelined`` while two worker threads run
    the rollouts (each thread's work goes to the same device; the overlap is
    the host side: IK of the lift and FK of the tracks against the plans'
    host reads).  Failures are resolved serially afterwards as in the
    serial mode: failed rollouts re-plan execution-verified, seeded with the
    observed failure, and with ``--cascade`` plan failures get the
    cascade."""
    import concurrent.futures as cf

    from omg_planner_torch.models import panda
    from omg_planner_torch.physics import NoMassModelError, execute_plan
    from omg_planner_torch.planner.runner import plan_pipelined

    model = panda.load_panda(collision_point_num=cfg.collision_point_num,
                             device=device)
    params = _pinch_params(args, device)
    rows_by_sid, results_by_sid, reps_by_sid = {}, {}, {}

    def run_exec(sid, scene, traj):
        t0 = time.time()
        try:
            rep = execute_plan(scene, traj, density=args.density,
                               pad_statics=pad, params=params)
            return sid, rep, None, time.time() - t0
        except NoMassModelError as e:
            return sid, None, str(e), time.time() - t0

    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        futs = []
        for sid, sc, res, dt in plan_pipelined(scenes, cfg, model=model,
                                               depth=8):
            row = {"scene": sid, "plan_wall_s": round(dt, 2)}
            rows_by_sid[sid] = row
            if res is None or not bool(np.asarray(res.flag)):
                row.update(plan_flag=False, reward=0, executed=False)
                continue
            row["plan_flag"] = True
            results_by_sid[sid] = res
            futs.append(pool.submit(run_exec, sid, sc,
                                    np.asarray(res.traj)))
        for fut in cf.as_completed(futs):
            sid, rep, skip, wall = fut.result()
            row = rows_by_sid[sid]
            if rep is None:
                row.update(executed=False, reward=0, skip_reason=skip)
            else:
                reps_by_sid[sid] = rep
                row.update(executed=True, exec_wall_s=round(wall, 3),
                           **rep.to_dict())
            print(f"scene {sid}: reward {row['reward']}", flush=True)

    if args.exec_retries > 0 or args.cascade:
        from omg_planner_torch.planner.exec_verify import \
            plan_execute_verified

        by_sid = dict(scenes)
        for sid, row in rows_by_sid.items():
            plan_failed = not row.get("plan_flag")
            exec_failed = bool(row.get("executed")) and row["reward"] == 0
            if plan_failed and not args.cascade:
                continue
            if not plan_failed and not exec_failed:
                continue
            if exec_failed and args.exec_retries == 0:
                continue
            seed = None
            if exec_failed and sid in results_by_sid:
                seed = (results_by_sid[sid], reps_by_sid.get(sid))
            out = plan_execute_verified(
                by_sid[sid], exec_retries=args.exec_retries,
                cascade=args.cascade, seed=seed, density=args.density,
                pad_statics=pad, params=params)
            if out is None or out.report is None:
                continue           # keep the recorded failure
            row.update(plan_flag=bool(np.asarray(out.result.flag)),
                       executed=True,
                       exec_attempts=out.exec_attempts + (1 if seed else 0),
                       verified=out.verified, **out.report.to_dict())
            print(f"scene {sid}: retried -> reward {row['reward']}",
                  flush=True)
    return [rows_by_sid[sid] for sid, _ in scenes]


def _run_serial(args, scenes, pad, device):
    from omg_planner_torch.physics import NoMassModelError, execute_plan

    params = _pinch_params(args, device)
    rows = []
    for sid, scene in scenes:
        t0 = time.time()
        if args.exec_retries > 0:
            from omg_planner_torch.planner.exec_verify import \
                plan_execute_verified

            out = plan_execute_verified(
                scene, exec_retries=args.exec_retries, cascade=args.cascade,
                density=args.density, pad_statics=pad, params=params)
            wall = round(time.time() - t0, 2)
            row = {"scene": sid, "plan_wall_s": wall}
            if out is None or not bool(np.asarray(out.result.flag)):
                row.update(plan_flag=False, reward=0, executed=False)
                print(f"scene {sid}: PLAN FAIL ({wall:.1f}s)", flush=True)
            elif out.report is None:
                row.update(plan_flag=True, executed=False, reward=0,
                           skip_reason="no mass model")
            else:
                row.update(plan_flag=True, executed=True,
                           exec_attempts=out.exec_attempts,
                           verified=out.verified, **out.report.to_dict())
                print(f"scene {sid}: plan ok -> reward {row['reward']} "
                      f"({out.exec_attempts} exec attempts, {wall:.1f}s)",
                      flush=True)
            rows.append(row)
            continue
        res = scene.step(fast=True)
        if args.cascade and (res is None or not bool(res.flag)):
            from omg_planner_torch.planner.cascade import plan_cascade
            cr = plan_cascade(scene)
            if cr is not None:
                res = cr.result
        t_plan = time.time() - t0
        row = {"scene": sid, "plan_wall_s": round(t_plan, 2)}
        if res is None or not bool(res.flag):
            row.update(plan_flag=False, reward=0, executed=False)
            rows.append(row)
            print(f"scene {sid}: PLAN FAIL ({t_plan:.1f}s)", flush=True)
            continue
        row["plan_flag"] = True
        t0 = time.time()
        want_video = bool(args.video) and not any(
            r.get("executed") for r in rows)
        try:
            out = execute_plan(scene, np.asarray(res.traj),
                               density=args.density, pad_statics=pad,
                               params=params, return_trace=want_video)
            rep, trace = out if want_video else (out, None)
            row.update(executed=True,
                       exec_wall_s=round(time.time() - t0, 3),
                       **rep.to_dict())
            if trace is not None:
                _write_replay(scene, trace, args)
        except NoMassModelError as e:     # no mass model for this target
            row.update(executed=False, reward=0, skip_reason=str(e))
        rows.append(row)
        print(f"scene {sid}: plan ok ({t_plan:.1f}s) -> reward "
              f"{row['reward']} lifted {row.get('lifted_m', 0):.3f} "
              f"({row.get('exec_wall_s', 0):.2f}s)", flush=True)
    return rows


if __name__ == "__main__":
    main()
