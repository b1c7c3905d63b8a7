"""``plan_fast``'s CUDA-graph updates (``planner/plan.py::_GraphedUpdates``,
``utils/graphs.py``) and their host-side pieces.

On the CPU the graphs cannot be captured, so ``utils/graphs.capture`` is
emulated: the capture runs the update once, as a real capture does, and
each later replay runs the same body again on the same fixed buffers and
copies its outputs into the captured ones.  The loop's
buffers, schedule, restarts, snapshot and terminating re-run are then held
bit for bit to the eager loop.  The card test holds the real graphs to the
eager loop on suite scenes 0-7 in both collision configurations."""

import os

import pytest
import torch

from omg_planner_torch.config import OMGConfig, schedule_weights
from omg_planner_torch.ops import learner as ol
from omg_planner_torch.ops.chomp import GoalSet
from omg_planner_torch.planner import plan as P
from omg_planner_torch.planner.scene import PlanningScene
from omg_planner_torch.utils import graphs
from omg_planner_torch.utils.graphs import GRAPHS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = OMGConfig(optim_steps=10, extra_smooth_steps=3, goal_set_max_num=12,
                  ik_seed_num=4, ik_max_iters=30, learner_interp_steps=10,
                  silent=True, learner_active_goals=4)
CFGS = {
    "default": OMGConfig(),
    "small": SMALL,
    "odd": OMGConfig(optim_steps=37, extra_smooth_steps=11, timesteps=23,
                     cost_schedule_decay=0.97, cost_schedule_boost=1.035,
                     step_decay_rate=0.993),
}


@pytest.mark.parametrize("name", list(CFGS))
def test_weight_rows_are_the_schedule(name):
    """Row ``step - sched0`` of the plan's weight table is
    ``schedule_weights(cfg, step - sched0 + 1)`` bit for bit, at every step
    and after any restart offset."""
    cfg = CFGS[name]
    rows, _ = P._plan_tables(cfg, "cpu")
    assert rows.shape == (cfg.total_steps, 4)
    assert rows.dtype == torch.float32
    for sched0 in (0, 1, cfg.total_steps // 3):
        for step in range(sched0, cfg.total_steps):
            want = torch.stack(schedule_weights(cfg, step - sched0 + 1))
            assert torch.equal(rows[step - sched0], want), (step, sched0)


@pytest.mark.parametrize("name", list(CFGS))
def test_start_rows_are_the_start_index(name):
    cfg = CFGS[name]
    _, starts = P._plan_tables(cfg, "cpu")
    assert starts.dtype == torch.int64
    for t in range(1, cfg.optim_steps + 1):
        assert int(starts[t]) == ol._start_index(cfg, float(t)), t


@pytest.mark.parametrize("standoff", [True, False])
def test_chosen_goal_gather_is_the_indexing(standoff):
    """The device gather of ``_chosen_goal`` equals the indexing it
    replaced, alone and under ``torch.func.vmap``."""
    cfg = OMGConfig(use_standoff=standoff)
    g = torch.Generator().manual_seed(3)
    grasps = torch.randn(12, 9, generator=g)
    gs = GoalSet(grasps, torch.randn(12, 5, 9, generator=g),
                 torch.ones(12, dtype=torch.bool), torch.zeros(12))
    for i in range(12):
        goal, tail = P._chosen_goal(cfg, gs, torch.tensor(i))
        assert torch.equal(goal, grasps[i])
        assert torch.equal(tail, gs.reach_grasps[i] if standoff
                           else grasps[i][None])
    batch = GoalSet(*(torch.stack([a, a.flip(0)]) for a in gs))
    idx = torch.tensor([2, 7])
    goal, tail = torch.func.vmap(
        lambda s, i: P._chosen_goal(cfg, s, i))(batch, idx)
    for b in range(2):
        assert torch.equal(goal[b], batch.grasps[b][idx[b]])
        want = (batch.reach_grasps[b][idx[b]] if standoff
                else batch.grasps[b][idx[b]][None])
        assert torch.equal(tail[b], want)


def _kinds(cfg, restricted, steps, restarts=()):
    """Each step's (learner kind or None, CHOMP kind) over ``steps`` steps
    of a graphed plan, restarting after each step of ``restarts`` as the
    loop does."""
    captured, t, out = set(), 0.0, []
    for s in range(steps):
        learner = None
        if P._learner_due(cfg, s):
            learner = P._update_kind(cfg, "learner", restricted, s, t,
                                     captured)
            t += 1.0
        chomp = P._update_kind(cfg, "chomp", restricted, s, t, captured)
        captured |= {p for p, k in (("learner", learner), ("chomp", chomp))
                     if k == "capture"}
        out.append((learner, chomp))
        if s in restarts:
            t = 0.0
    return out


def test_schedule_of_the_default_cfg():
    cfg = OMGConfig()
    kinds = _kinds(cfg, True, cfg.total_steps)
    assert kinds[0] == ("eager", "eager")
    assert kinds[1] == (None, "eager")
    assert kinds[2] == ("capture", "capture")
    # the learner's t-th update is on step 2 (t - 1); t = 10, 20 refresh
    for s, (learner, chomp) in enumerate(kinds[3:], start=3):
        assert chomp == "replay"
        if s >= cfg.optim_steps or s % 2:
            assert learner is None, s
        elif s in (18, 38):
            assert learner == "refresh", s
        else:
            assert learner == "replay", s
    # an unrestricted sweep (goal capacity at most the active lanes) is
    # eager on every learner step; the CHOMP update is graphed alike
    full = _kinds(cfg, False, cfg.total_steps)
    assert [k[0] for k in full] == [
        "eager" if k[0] is not None else None for k in kinds]
    assert [k[1] for k in full] == [k[1] for k in kinds]


def test_schedule_across_blacklist_restarts():
    """The default blacklist cadence restarts after steps 11, 17, 23, ...;
    a restart sets the learner's count back to 0, so its refresh falls 10
    updates later, and the graphs, once captured, stay."""
    cfg = OMGConfig()
    due = [s for s in range(cfg.total_steps) if P._blacklist_due(cfg, s)]
    assert due[:3] == [11, 17, 23]
    kinds = _kinds(cfg, True, cfg.total_steps, restarts=(11, 17))
    learner_steps = [s for s, k in enumerate(kinds) if k[0] is not None]
    assert learner_steps == list(range(0, cfg.optim_steps, 2))
    # t: steps 0..10 -> 1..6; restart; 12, 14, 16 -> 1..3; restart;
    # 18, 20, ... -> 1, 2, ...: the refresh at t = 10 is step 36
    refresh = [s for s, k in enumerate(kinds) if k[0] == "refresh"]
    assert refresh == [36]
    assert [k[1] for k in kinds].count("capture") == 1
    assert [k[0] for k in kinds].count("capture") == 1
    assert all(k[0] in (None, "replay") for s, k in enumerate(kinds)
               if s > 2 and s != 36)


class _Segment:
    """A ``torch.cuda.CUDAGraph`` stand-in that logs what is done with
    it."""

    log = []

    def capture_begin(self, pool=None, capture_error_mode=None):
        self.log.append(("begin", graphs.capturing()))

    def capture_end(self):
        self.log.append(("end", graphs.capturing()))

    def replay(self):
        self.log.append("replay")


def test_outside_runs_between_segments(monkeypatch):
    """A launch handed to ``graphs.outside`` while capturing cuts the
    capture into two segments and runs eagerly between them (out of the
    capture), at the capture and at each replay; a replay calls it through
    its owner's attribute, so whatever wraps that attribute sees each
    launch once, with a copy of each ``fresh`` argument; its outputs are
    copied into the tensors the next segment read."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Segment)
    monkeypatch.setattr(_Segment, "log", [])
    owner = type("Owner", (), {})()
    launched, called = [], []

    def launch(x, y):
        launched.append((x, y, graphs.capturing()))
        return x + y, x * y

    def kernel(x, y):
        if graphs.capturing():
            return graphs.outside(owner, "kernel", launch, (x, y),
                                  fresh=(0,))
        return launch(x, y)

    def recorder(x, y):   # a wrapper put around the owner's attribute
        called.append(x)
        return kernel(x, y)

    owner.kernel = recorder
    x, y = torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])
    g = graphs.Graph(type("Pool", (), {"id": None})())
    g._begin()
    out = owner.kernel(x, y)
    g._end()
    assert not graphs.capturing()
    assert _Segment.log == [("begin", False), ("end", False), "replay",
                            ("begin", False), ("end", False), "replay"]
    assert len(called) == len(launched) == 1
    a, b, cap = launched[0]
    assert a is x and b is y and not cap
    assert torch.equal(out[0], x + y) and torch.equal(out[1], x * y)
    x.copy_(torch.tensor([5.0, 6.0]))   # a segment writes the input
    _Segment.log.clear()
    g.replay()
    assert _Segment.log == ["replay", "replay"]
    assert len(called) == len(launched) == 2
    a, b, cap = launched[1]
    assert a is not x and torch.equal(a, x) and b is y and not cap
    assert called[1] is a
    assert torch.equal(out[0], x + y) and torch.equal(out[1], x * y)


class _EmulatedGraph:
    """A capture emulated on the CPU: the capture ran the body once;
    replays run it again and write its outputs into the first run's."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        for o, n in zip(self.out, self.body()):
            o.copy_(n)


@pytest.fixture
def emulated(monkeypatch):
    def capture(body, device):
        out = body()
        return _EmulatedGraph(body, out), out

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "retain", lambda kept, device: None)


BLACKLIST = SMALL.replace(inplan_blacklist_step=3, inplan_blacklist_every=2)
REFRESH = SMALL.replace(inplan_blacklist_step=0, learner_refresh_every=2,
                        learner_sweep_every=1)
CASES = {
    # restarts on the blacklist and terminates: the re-run gives the info
    "suite0_blacklist": (BLACKLIST, 0, True),
    # restarts and runs out its budget: the final re-evaluation
    "suite4_blacklist_budget": (BLACKLIST, 4, False),
    # the learner every step, a refresh sweep every second update
    "suite0_refresh": (REFRESH, 0, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_loop_is_the_eager_loop(case, emulated):
    cfg, sid, terminates = CASES[case]
    scene = PlanningScene.from_npz(
        cfg, os.path.join(ROOT, "data", "suite_v2", f"scene_{sid}.npz"),
        device="cpu")
    problem = scene.build_problem()
    hp = cfg.horizon().on("cpu")
    want = P.plan_fast(scene.model, cfg, problem, _graphs=False)
    GRAPHS.reset()
    # plan_fast's loop with the graphed updates (which it takes on a card)
    carry = P._init_carry(scene.model, cfg, hp, problem)
    updates = P._GraphedUpdates(scene.model, cfg, hp, problem)
    while not carry.done and carry.step < cfg.total_steps:
        carry = P._step(scene.model, cfg, hp, problem, carry,
                        updates=updates)
    traj, info = P._finish(scene.model, cfg, hp, problem, carry)
    assert carry.step == int(want.steps_used)
    assert torch.equal(carry.goal_idx, want.goal_idx)
    assert torch.equal(carry.goal_mask, want.goal_mask)
    assert torch.equal(traj, want.traj)
    for name, a, b in zip(info._fields, info, want.info):
        assert torch.equal(a, b), name
    if terminates is not None:
        assert carry.done == terminates == bool(want.flag)
        assert (want.goal_mask != problem.goal_set.mask).any()  # restarted
    counts = GRAPHS.counts
    eager = P._EAGER_STEPS
    assert carry.step > eager
    assert counts["chomp"]["capture"] == 1
    assert counts["chomp"]["replay"] == carry.step - eager - 1
    assert counts["chomp"]["eager"] == eager + carry.done
    if case == "suite0_refresh":
        assert counts["learner"]["capture"] == 1
        assert counts["learner"]["eager"] >= 2  # step 0 and a refresh
        assert counts["learner"]["replay"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("analytic", [True, False],
                         ids=["panda_analytic", "panda_voxel"])
def test_graphs_on_card_are_the_eager_loop(analytic):
    """Real graphs on the card against the eager loop, bit for bit, on suite
    scenes 0-7 (among them blacklist restarts and a 70-step plan)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = OMGConfig(silent=True, sdf_analytic=analytic)
    restarted = full = 0
    for sid in range(8):
        scene = PlanningScene.from_npz(
            cfg, os.path.join(ROOT, "data", "suite_v2", f"scene_{sid}.npz"),
            device="cuda")
        problem = scene.build_problem()
        want = P.plan_fast(scene.model, cfg, problem, _graphs=False)
        got = P.plan_fast(scene.model, cfg, problem)
        for f in ("traj", "goal_idx", "steps_used", "flag", "goal_mask"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (sid, f)
        for name, a, b in zip(got.info._fields, got.info, want.info):
            assert torch.equal(a, b), (sid, name)
        restarted += bool((want.goal_mask != problem.goal_set.mask).any())
        full += int(want.steps_used) == cfg.total_steps
    assert restarted and full
