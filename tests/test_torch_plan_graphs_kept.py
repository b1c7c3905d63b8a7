"""CUDA graphs of the plan step kept across plans (``planner/plan.py::
_GraphedUpdates``, ``_Kept``; ``utils/graphs.py``'s store).

On the CPU the capture is emulated as in ``test_torch_plan_graphs.py``, but
the store stays live: the first plan of a key captures (the emulated graph
runs its body), a later plan of the key takes the kept graphs over and
replays them (the body runs again on the kept buffers and the problem the
entry holds for the running plan).  The plans are held bit for bit to the
eager loop, and a plan's result to stay as it was while later plans run
on the kept buffers.  The card test does the same with real graphs on
suite scenes 0-7 in both collision configurations."""

import gc
import os
import weakref

import pytest
import torch

from omg_planner_torch.config import OMGConfig
from omg_planner_torch.planner import plan as P
from omg_planner_torch.planner.scene import PlanningScene
from omg_planner_torch.utils import graphs
from omg_planner_torch.utils.graphs import GRAPHS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = OMGConfig(optim_steps=10, extra_smooth_steps=3, goal_set_max_num=12,
                  ik_seed_num=4, ik_max_iters=30, learner_interp_steps=10,
                  silent=True, learner_active_goals=4)
BLACKLIST = SMALL.replace(inplan_blacklist_step=3, inplan_blacklist_every=2)
CFGS = {"blacklist": BLACKLIST,
        "no_snapshot": SMALL.replace(exec_snapshot=False)}
RESULT = ("traj", "goal_idx", "goal_mask", "steps_used", "flag")


class _Emulated:
    """A capture emulated on the CPU: the capture ran the body once;
    replays run it again and write its outputs into the first run's."""

    def __init__(self, body, out):
        self.body, self.out = body, out
        self.pointed = []

    def replay(self):
        for o, n in zip(self.out, self.body()):
            o.copy_(n)

    def repoint(self, old, new):
        self.pointed.append(new)


@pytest.fixture
def kept(monkeypatch):
    def capture(body, device):
        out = body()
        return _Emulated(body, out), out

    monkeypatch.setattr(graphs, "capture", capture)
    graphs._LOCAL.__dict__.pop("kept", None)
    yield
    graphs._LOCAL.__dict__.pop("kept", None)


def _problem(cfg, sid, device="cpu"):
    scene = PlanningScene.from_npz(
        cfg, os.path.join(ROOT, "data", "suite_v2", f"scene_{sid}.npz"),
        device=device)
    return scene, scene.build_problem()


def _graphed(model, cfg, problem):
    """``plan_fast`` with the graphed updates it takes on a card."""
    hp = cfg.horizon().on(problem.start.device)
    carry = P._init_carry(model, cfg, hp, problem)
    return P._fast_loop(model, cfg, hp, problem, carry,
                        P._GraphedUpdates(model, cfg, hp, problem))


def _same(got, want, what):
    for f in RESULT:
        assert torch.equal(getattr(got, f), getattr(want, f)), (what, f)
    for name, a, b in zip(got.info._fields, got.info, want.info):
        assert torch.equal(a, b), (what, name)


def _counts():
    return {p: dict(c) for p, c in GRAPHS.counts.items()}


@pytest.mark.parametrize("name", list(CFGS))
def test_later_plans_take_the_kept_graphs_over(kept, name):
    """Suite scene 4 (10 objects, runs out its budget) captures; scene 24
    (11 objects; with the blacklist it restarts and terminates) replays the
    kept graphs from its first graphed update; scene 0 at another goal
    capacity is another key and captures anew.  Every plan is the eager
    loop's, and scene 4's result (without the snapshot, its trajectory and
    goal index are what the last graphed updates wrote) stays as it was
    while scene 24 runs on the kept buffers."""
    cfg = CFGS[name]
    cases = [(cfg, 4), (cfg, 24), (cfg.replace(goal_set_max_num=16), 0)]
    runs = []
    for c, sid in cases:
        scene, problem = _problem(c, sid)
        runs.append((scene, problem, P.plan_fast(scene.model, c, problem,
                                                 _graphs=False)))
    assert (runs[0][1].scene.num_objects != runs[1][1].scene.num_objects)
    got, counts = [], []
    for (c, sid), (scene, problem, want) in zip(cases, runs):
        GRAPHS.reset()
        res = _graphed(scene.model, c, problem)
        _same(res, want, sid)
        got.append(res)
        counts.append(_counts())
        if len(got) == 1:
            before = {f: getattr(res, f).clone() for f in RESULT}
            before.update(("info." + n, v.clone())
                          for n, v in zip(res.info._fields, res.info))
    first, second, third = counts
    for piece in graphs.PIECES:
        assert (first[piece]["capture"], first[piece]["kept"]) == (1, 0)
        assert (second[piece]["capture"], second[piece]["kept"]) == (0, 1)
        assert second[piece]["replay"] >= 1
        assert (third[piece]["capture"], third[piece]["kept"]) == (1, 0)
    a = got[0]
    for f in RESULT:
        assert torch.equal(getattr(a, f), before[f]), f
    for n, v in zip(a.info._fields, a.info):
        assert torch.equal(v, before["info." + n]), n
    # and none of them is a kept buffer
    store = graphs._LOCAL.kept["cpu"]
    assert len(store) == 2
    # scene 24's plan pointed the eager calls at its scene, then at the
    # placeholders again
    a_problem, b_problem = runs[0][1], runs[1][1]
    entry = store[P._graph_key(runs[0][0].model, cfg, a_problem)]
    for graph, _ in entry.graphs.values():
        assert len(graph.pointed) == 3
        assert graph.pointed[0] is graph.pointed[2] is entry.dropped
        assert all(x is y for x, y in zip(
            graph.pointed[1], (b_problem.scene, *b_problem.cost_params)))
    bufs = {t.untyped_storage().data_ptr()
            for k in store.values()
            for t in list(k.bufs.values()) + k.inputs}
    for f in RESULT:
        assert getattr(a, f).untyped_storage().data_ptr() not in bufs, f


def test_kept_graphs_hold_no_scene(kept):
    """Between plans the kept entry points the eager calls between the
    segments at placeholders and holds no problem: once the plan's scene is
    gone, nothing keeps its tensors."""
    scene, problem = _problem(BLACKLIST, 4)
    _graphed(scene.model, BLACKLIST, problem)
    refs = [weakref.ref(t) for t in (*problem.scene, *problem.cost_params,
                                     problem.goal_set.grasps, problem.start)]
    key = P._graph_key(scene.model, BLACKLIST, problem)
    del scene, problem
    gc.collect()
    assert all(r() is None for r in refs)
    entry = graphs._LOCAL.kept["cpu"][key]
    assert entry.problem is None and entry.pointed is entry.dropped
    for graph, _ in entry.graphs.values():
        assert graph.pointed == [entry.dropped]   # at the plan's release


def test_store_keeps_the_latest_owners():
    """``retain`` keeps at most ``KEEP`` owners a thread and device, the
    latest retained; ``take`` takes one out."""
    graphs._LOCAL.__dict__.pop("kept", None)
    owners = [type("Owner", (), {"key": ("k", i)})()
              for i in range(graphs.KEEP + 2)]
    try:
        for o in owners[:graphs.KEEP]:
            graphs.retain(o, "cpu")
        assert graphs.take(("k", 0), "cpu") is owners[0]
        assert graphs.take(("k", 0), "cpu") is None
        graphs.retain(owners[0], "cpu")   # now the latest
        for o in owners[graphs.KEEP:]:
            graphs.retain(o, "cpu")
        kept = list(graphs._LOCAL.kept["cpu"].values())
        assert kept == (owners[3:graphs.KEEP] + [owners[0]]
                        + owners[graphs.KEEP:])
        assert graphs.take(("k", 1), "cpu") is None
        assert graphs.take(("k", 0), "cuda:0") is None
    finally:
        graphs._LOCAL.__dict__.pop("kept", None)


class _Segment:
    """A ``torch.cuda.CUDAGraph`` stand-in."""

    def capture_begin(self, pool=None, capture_error_mode=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


def test_repoint_gives_the_eager_calls_other_arguments(monkeypatch):
    """``Graph.repoint`` swaps, by identity, the arguments an eager call
    between the segments takes; the others stay."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Segment)
    owner = type("Owner", (), {})()
    launched = []

    def launch(scene, x):
        launched.append((scene, x))
        return (x * scene,)

    def kernel(scene, x):
        if graphs.capturing():
            return graphs.outside(owner, "kernel", launch, (scene, x))
        return launch(scene, x)

    owner.kernel = kernel
    s, x = torch.tensor(2.0), torch.tensor([1.0, 3.0])
    g = graphs.Graph(type("Pool", (), {"id": None})())
    g._begin()
    out, = owner.kernel(s, x)
    g._end()
    assert torch.equal(out, x * 2)
    s2 = torch.tensor(5.0)
    g.repoint((s,), (s2,))
    g.replay()
    assert launched[-1][0] is s2 and launched[-1][1] is x
    assert torch.equal(out, x * 5)
    gone = object()
    ref = weakref.ref(s2)
    g.repoint((s2,), (gone,))
    del s2, launched[:]
    gc.collect()
    assert ref() is None
    g.repoint((gone,), (s,))
    g.replay()
    assert launched[-1][0] is s and torch.equal(out, x * 2)


@pytest.mark.gpu
@pytest.mark.parametrize("analytic", [True, False],
                         ids=["panda_analytic", "panda_voxel"])
def test_kept_graphs_on_card_are_the_eager_loop(analytic):
    """Real graphs kept across suite scenes 0-7, forward then backward:
    every plan bit for bit the eager loop's, one capture a piece for the
    16 plans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = OMGConfig(silent=True, sdf_analytic=analytic)
    graphs._LOCAL.__dict__.pop("kept", None)
    try:
        runs = []
        for sid in range(8):
            scene, problem = _problem(cfg, sid, "cuda")
            runs.append((scene, problem, P.plan_fast(
                scene.model, cfg, problem, _graphs=False)))
        GRAPHS.reset()
        for sid in list(range(8)) + list(range(7, -1, -1)):
            scene, problem, want = runs[sid]
            _same(P.plan_fast(scene.model, cfg, problem), want, sid)
        counts = _counts()
        for piece in graphs.PIECES:
            assert counts[piece]["capture"] == 1, counts
            assert counts[piece]["kept"] >= 1, counts
        # the store dropped (as its evictions may leave it), the pool
        # takes a new capture
        graphs._LOCAL.__dict__.pop("kept", None)
        longest = max(range(8), key=lambda i: int(runs[i][2].steps_used))
        scene, problem, want = runs[longest]
        _same(P.plan_fast(scene.model, cfg, problem), want, longest)
        for piece in graphs.PIECES:
            assert GRAPHS.counts[piece]["capture"] == 2, GRAPHS.counts
    finally:
        graphs._LOCAL.__dict__.pop("kept", None)


@pytest.mark.gpu
def test_kept_learner_graph_outlives_model_churn():
    """A request may set ``learner_collision_points``: the learner then
    scores on the model's thinned copy, whose tables a kept learner graph
    reads.  Scenes 0-3 plan on one key with it set; between them 20 other
    models are made and run through the kernels, and a second key (the
    other collision configuration) captures into the pool.  Every plan is
    bit for bit the eager loop's, and the first key captured once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from omg_planner_torch.models import api
    from omg_planner_torch.ops import ik as ik_ops

    cfg = OMGConfig(silent=True, learner_collision_points=5)
    other = cfg.replace(sdf_analytic=not cfg.sdf_analytic)
    graphs._LOCAL.__dict__.pop("kept", None)
    try:
        runs = []
        for sid, c in ((0, cfg), (1, cfg), (2, cfg), (3, cfg), (4, other)):
            scene, problem = _problem(c, sid, "cuda")
            runs.append((c, scene.model, problem, P.plan_fast(
                scene.model, c, problem, _graphs=False)))
        model = runs[0][1]
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = torch.rand(64, 9, device="cuda", generator=gen)
        lo7, hi7 = model.joint_lower[:7], model.joint_upper[:7]
        GRAPHS.reset()
        for i in range(4):
            c, m, problem, want = runs[i]
            _same(P.plan_fast(m, c, problem), want, i)
            for k in range(20):
                churn = model._replace(collision_points=torch.rand(
                    10, 5 + k % 7, 3, device="cuda", generator=gen))
                api.fk_points(churn, q)
                ik_ops.ik_batch_fixed(churn, api.hand_poses(churn, q),
                                      q[:, :7], c, lo7, hi7, 2)
            c, m, problem, want = runs[4]
            _same(P.plan_fast(m, c, problem), want, "other key")
        counts = _counts()
        for piece in graphs.PIECES:
            assert counts[piece]["capture"] == 2, counts
            assert counts[piece]["kept"] >= 1, counts
    finally:
        graphs._LOCAL.__dict__.pop("kept", None)
