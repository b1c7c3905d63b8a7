"""The collision query kernel's two layouts (``csrc/sdf_query.cu``: spread,
one warp an object, and loop, one thread a point) timed against each
other on the card at the plan's shapes, to place the switch between them.

    python3 scripts/sdf_query_layouts.py

Builds three libraries from this checkout's source: the package's own
(``OMG_SDF_SPREAD_TILES`` at its default), one that always spreads and one
that always loops; runs each on suite scene 1 (O = 10), analytic and
baked, at B = 1 and P = 4,500, 72,000, 225,000 and at B = 8 (the rows
sharing the scene) and P = 4,500, 72,000; prints each one's time (50
launches in one CUDA graph, median of 5 replays, ``chip_smoke.time_graph``)
and whether the three give the same bits.  The card's name and power limit
come first.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from omg_planner_torch.config import OMGConfig  # noqa: E402
from omg_planner_torch.ops import kernels  # noqa: E402
from omg_planner_torch.ops import sdf as sdf_mod  # noqa: E402
from omg_planner_torch.planner.scene import PlanningScene  # noqa: E402

BUILDS = {"package": (),
          "spread": ("-DOMG_SDF_SPREAD_TILES=0x7fffffffffffLL",),
          "loop": ("-DOMG_SDF_SPREAD_TILES=0",)}


def build(out_dir: str) -> dict:
    """{(build, form): C entry point}, the three builds compiled together."""
    src = os.path.join(kernels.CSRC, "sdf_query.cu")
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-o",
         os.path.join(out_dir, f"lib{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in BUILDS.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        for form in ("analytic", "baked"):
            entry = f"omg_sdf_query_{form}"
            fn = getattr(lib, entry)
            fn.argtypes = kernels._LIBS["sdf_query"][2][entry]
            fn.restype = ctypes.c_int
            fns[(name, form)] = fn
    return fns


def main() -> int:
    dev = "cuda"
    cs.phase_environment()
    out_dir = os.path.join(ROOT, "build", "sdf_query_layouts")
    os.makedirs(out_dir, exist_ok=True)
    fns = build(out_dir)
    scene = PlanningScene.from_npz(OMGConfig(silent=True), os.path.join(
        cs.SUITE, "scene_1.npz"), device=dev)
    model, params = scene.model, scene.env.cost_params()
    rest = (params.epsilons, params.padding_scales, params.clearances,
            params.disables)
    scenes = {"analytic": scene.env.scene_sdf(),
              "baked": sdf_mod.stage_scene_sdfs(
                  [o.sdf for o in scene.env.objects], dev, baked=True)}
    gen = torch.Generator().manual_seed(11)
    same = True
    for form, sc in scenes.items():
        for b, p in ((1, 4500), (1, 72000), (1, 225000), (8, 4500),
                     (8, 72000)):
            x = kernels.panda_fk(cs._in_limits(model, b * p // 150, gen),
                                 model.pose_0, model.chain_post,
                                 model.center_offset, model.collision_points
                                 )[3].reshape(b, p, 3)
            inv = params.inv_poses[None].repeat(b, 1, 1, 1)
            inv[..., :3, 3] += torch.linspace(-0.03, 0.04, b,
                                              device=dev)[:, None, None]
            rows = [inv, x] + [t[None].expand(b, *t.shape) for t in rest]
            scene_rows = [t[None].expand(b, *t.shape) for t in sc]
            times, outs = [], {}
            for name in BUILDS:
                keep, out, ptrs, dims = kernels._sdf_query_pack(rows,
                                                                scene_rows)
                fn = fns[(name, form)]

                def run(fn=fn, ptrs=ptrs, dims=dims):
                    status = fn(ptrs, dims,
                                torch.cuda.current_stream().cuda_stream)
                    if status != 0:
                        raise RuntimeError(f"CUDA error {status}")
                times.append(f"{name} {cs.time_graph(run):.4f} ms")
                torch.cuda.synchronize()
                outs[name] = out
                del keep
            equal = all(torch.equal(a, c) for o in outs.values()
                        for a, c in zip(o, outs["package"]))
            same &= equal
            print(f"sdf_query {form} B={b} P={p}: {', '.join(times)}; "
                  f"{'bit-equal' if equal else 'DIFFERENT'}", flush=True)
    print(f"LAYOUTS: {'SAME BITS' if same else 'DIFFERENT'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
