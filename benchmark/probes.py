"""What the benchmark reads from the program while a run goes: wrappers
put around the program's functions at run time (no program file changes).

Always on (a reference to each tensor, no device work, no host read):

* every plan's goal set, its final result, and the inputs and outputs of
  its first and last CHOMP steps (``plan._chomp_update``, with the body
  points and the query's outputs of ``chomp._fk_query`` and the obstacle
  terms of ``kernels.chomp_obstacle`` inside it), for the comparison with
  the reference.

With spans on (traced runs only), each of these closes on
``torch.cuda.synchronize()`` and records its host interval:

* ``scene_build``: ``apps/serve.py::_build_scene``;
* ``scene_stage``: ``planner/scene.py::Env.stage_scene``, the collision
  scene put on the device (inside the goal-set build on the fresh path);
* ``goal_set``: ``planner/scene.py::PlanningScene.build_problem``;
* ``plan``: ``planner/plan.py::plan_fast``;

and while the device is being profiled, each ``chomp_obstacle`` and
``sdf_query`` launch's work is counted from its arguments, and so is each
launch of the hand kernels that the configuration names (``kernels``:
each wrapped in a traced run only, its work counted by its module's
``work(args, kwargs)``).
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

import work

# the kernels whose launches these probes count in their own wrappers
COUNTED = ("chomp_obstacle", "sdf_query")


class Probes:
    def __init__(self, spans: bool, cuda: bool = True, kernels=None):
        self.spans_on = spans
        self._sync = torch.cuda.synchronize if cuda else (lambda: None)
        self.spans = []            # (name, t0, t1)
        self.plans = []            # finished plans' captures, in order
        self._current = None
        self._pending = None
        self.kernels = kernels or {}   # name -> its work module
        self.launches = {k: [] for k in COUNTED + tuple(self.kernels)}
        self.counting = False
        self._nz = {}
        self._saved = []

    # -- installing -------------------------------------------------------
    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        # the wrapper carries the original's attributes (the kernels'
        # launch counters, which the program bumps through the name)
        setattr(owner, name, functools.update_wrapper(make(orig), orig))

    def install(self):
        from omg_planner_torch.apps import serve
        from omg_planner_torch.ops import chomp, kernels
        from omg_planner_torch.planner import plan, runner, scene

        def plan_fast(orig):
            def wrapped(model, cfg, problem, *a, **k):
                cap = {"goal_set": problem.goal_set, "steps": []}
                self._current = cap
                with self.span("plan"):
                    res = orig(model, cfg, problem, *a, **k)
                cap["result"] = res
                self._current = None
                self.plans.append(cap)
                return res
            return wrapped

        for owner in (plan, runner, serve):
            self._wrap(owner, "plan_fast", plan_fast)

        def chomp_update(orig):
            def wrapped(model, cfg, hp, problem, traj, goal_idx, weights):
                cap = self._current
                if cap is None:
                    return orig(model, cfg, hp, problem, traj, goal_idx,
                                weights)
                self._pending = pend = {"xi": traj, "goal_idx": goal_idx,
                                        "weights": weights}
                out = orig(model, cfg, hp, problem, traj, goal_idx, weights)
                self._pending = None
                pend["new_xi"], pend["info"] = out
                steps = cap["steps"]
                if len(steps) < 2:
                    steps.append(pend)
                else:
                    steps[1] = pend
                return out
            return wrapped

        self._wrap(plan, "_chomp_update", chomp_update)

        def fk_query(orig):
            def wrapped(*a, **k):
                out = orig(*a, **k)
                if self._pending is not None:
                    self._pending["query"] = out
                return out
            return wrapped

        self._wrap(chomp, "_fk_query", fk_query)

        def chomp_obstacle(orig):
            def wrapped(*args):
                out = orig(*args)
                if self._pending is not None:
                    self._pending["obs"] = out
                if self.counting:
                    key = args[8].data_ptr()
                    if key not in self._nz:
                        self._nz[key] = work._nonzero(
                            args[8][:2, :args[5].shape[-3]])
                    self.launches["chomp_obstacle"].append(
                        work.chomp_obstacle_work(args, self._nz[key]))
                return out
            return wrapped

        self._wrap(kernels, "chomp_obstacle", chomp_obstacle)

        def sdf_query(orig):
            def wrapped(scene_, inv_poses, points, eps, pad, clear, disables):
                if self.counting:
                    self.launches["sdf_query"].append(
                        (scene_, inv_poses, points, disables))
                return orig(scene_, inv_poses, points, eps, pad, clear,
                            disables)
            return wrapped

        self._wrap(kernels, "sdf_query", sdf_query)

        if self.spans_on:
            for owner, name, label in (
                    (serve, "_build_scene", "scene_build"),
                    (scene.Env, "stage_scene", "scene_stage"),
                    (scene.PlanningScene, "build_problem", "goal_set")):
                self._wrap(owner, name, self._spanned(label))
            for name, mod in self.kernels.items():
                self._wrap(kernels, name, self._counted(name, mod.work))

    def uninstall(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []

    # -- spans ------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name):
        if not self.spans_on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.spans.append((name, t0, time.perf_counter()))

    def _spanned(self, label):
        def make(orig):
            def wrapped(*a, **k):
                with self.span(label):
                    return orig(*a, **k)
            return wrapped
        return make

    def _counted(self, name, work):
        def make(orig):
            def wrapped(*args, **kwargs):
                if self.counting:
                    self.launches[name].append(work(args, kwargs))
                return orig(*args, **kwargs)
            return wrapped
        return make

    # -- the captures as the reference takes them --------------------------
    def drop(self, index: int):
        """Release the captures of plan ``index`` (not in the sample)."""
        self.plans[index] = None

    def sdf_launch_work(self) -> list:
        """(flops, bytes) of each counted ``sdf_query`` launch (reads the
        device: after the window)."""
        out = []
        for sc, inv, pts, dis in self.launches["sdf_query"]:
            if hasattr(sc, "data4"):
                rows = type("Rows", (), {})()
                rows.data4, rows.limits = sc.data4[None], sc.limits[None]
            else:
                rows = type("Rows", (), {})()
                rows.kinds = sc.kinds[None]
            out.append(work.sdf_work(rows, inv[None], pts[None], dis[None]))
        return out


    def named_launch_work(self) -> dict:
        """(flops, bytes) of each counted launch of the named kernels, by
        kernel; a count that ``work`` deferred (a callable) is read here,
        after the window."""
        return {k: [w() if callable(w) else w for w in self.launches[k]]
                for k in self.kernels}


def step_record(step: dict) -> dict:
    """A captured step as host tensors, in the reference's names."""
    x, og, ax, pot, grad, coll = step["query"]
    obs_cost, obs_grad, obs_coll = step["obs"]
    info = step["info"]
    floats = torch.cat([torch.stack([
        info.cost, info.obs, info.smooth, info.weighted_obs,
        info.weighted_smooth, info.grad_norm, info.smooth_grad_norm,
        info.obs_grad_norm, info.collide, info.reach]).float(),
        info.cost_traj.float()])
    flags = torch.stack([info.terminate, info.failure_terminate,
                         info.execute, info.violate_limit])
    cpu = {k: v.detach().cpu() for k, v in dict(
        xi=step["xi"], goal_idx=step["goal_idx"], x=x, og=og, ax=ax,
        pot=pot, grad=grad, collide=coll, obs_cost=obs_cost,
        obs_grad=obs_grad, obs_collide=obs_coll, new_xi=step["new_xi"],
        floats=floats, flags=flags).items()}
    cpu["weights"] = [float(w) for w in step["weights"][:2]] + [
        float(step["weights"][3])]
    return cpu


def plan_record(cap: dict, body: dict, answer: dict) -> dict:
    """A captured plan with its request body and its answer, on the
    host."""
    gs = cap["goal_set"]
    res = cap["result"]
    info = res.info
    return {
        "body": body,
        "goal_set": tuple(t.detach().cpu() for t in (
            gs.grasps, gs.reach_grasps, gs.mask, gs.potentials)),
        "steps": [step_record(s) for s in cap["steps"]],
        "result": {"traj": answer["traj"], "flag": answer["flag"],
                   "smooth": float(info.smooth),
                   "collide": float(info.collide),
                   "reach": float(info.reach)},
    }
