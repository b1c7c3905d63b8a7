"""Offline shape-pipeline CLI (counterpart of
``omg_planner_tpu/apps/process_shape.py``; reference
``real_world/process_shape.py:86-179``: SDFGen + VHACD + point sampling
orchestration for one mesh).

Run:  ``python -m omg_planner_torch.apps.process_shape -f mesh.obj [-a] [...]``

Produces, next to the mesh (or under ``--out``): ``<base>_chomp.pkl``
(SDF volume), ``<base>.xyz`` (surface points), ``<base>.extent.txt``,
and with ``-a``/``--convex`` the ``<base>_convex.obj`` piece hulls
(the VHACD step).  All native work runs in ``native/meshsdf.cpp``, built
by ``io/meshsdf.py`` under ``build/omg_meshsdf/``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--file", required=True, help="wavefront .obj")
    ap.add_argument("-a", "--all", action="store_true",
                    help="full pipeline incl. convex decomposition")
    ap.add_argument("--convex", action="store_true")
    ap.add_argument("--out", default=None, help="output directory")
    ap.add_argument("--target-dim", type=int, default=64,
                    help="SDF cells across the largest extent "
                         "(reference gen_sdf.py:39-56 sizing)")
    ap.add_argument("--padding", type=int, default=20)
    ap.add_argument("--repair", action="store_true",
                    help="topology repair first (merge doubles + coherent "
                         "outward winding — the geometry part of the "
                         "reference's blender step, "
                         "real_world/blender_process.py:53-63); also "
                         "writes <base>.processed.obj")
    args = ap.parse_args(argv)

    from ..io.meshsdf import process_mesh

    sdf, pts, extents = process_mesh(
        args.file, out_dir=args.out, convex=args.all or args.convex,
        repair=args.all or args.repair,
        target_dim=args.target_dim, padding=args.padding)
    print(f"sdf {sdf.data.shape} delta {sdf.delta:.4f} "
          f"origin {sdf.origin.tolist()} | {len(pts)} surface points | "
          f"extents {extents.tolist()}")


if __name__ == "__main__":
    main()
