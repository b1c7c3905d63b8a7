"""Replay saved demonstrations as videos (counterpart of
``omg_planner_tpu/apps/vis_demos.py``; reference ``bullet/vis_data.py``).

Usage:  python -m omg_planner_torch.apps.vis_demos -d data/demonstrations
[--cpu]

Each object of a demo is drawn as a box proxy at its saved pose (the demo
records poses and names, not shapes).  FK runs on ``cuda`` unless
``--cpu`` is given; drawing needs matplotlib, and without cv2 the frames
go to ``<demo>.avi.npz``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def replay(demo_path: str, out_path: str | None = None, every: int = 2,
           device=None):
    from ..io.assets import make_primitive
    from ..models import panda
    from ..viz.render import render_trajectory, write_video

    model = panda.load_panda(device=device)
    d = dict(np.load(demo_path, allow_pickle=True))
    traj = d["traj"]
    objects = []
    if "scene_poses" in d and "scene_names" in d:
        for name, pose in zip(d["scene_names"], d["scene_poses"]):
            objects.append(make_primitive(
                str(name), "box", [0.05, 0.05, 0.08], pose,
                compute_grasp=False, delta=0.02))
    frames = render_trajectory(model, objects, traj, every=every)
    out_path = out_path or demo_path.replace(".npz", ".avi")
    write_video(frames, out_path)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--dir", default="data/demonstrations")
    ap.add_argument("--cpu", action="store_true",
                    help="run FK on the CPU instead of cuda")
    args = ap.parse_args(argv)
    from .. import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    out = []
    for path in sorted(glob.glob(os.path.join(args.dir, "demo_*.npz"))):
        out.append(replay(path, device=device))
        print("wrote", out[-1])
    return out


if __name__ == "__main__":
    main()
