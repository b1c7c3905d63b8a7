"""What a kernel launch must do, counted from its own arguments: the
operations and bytes of one ``chomp_obstacle`` or ``sdf_query`` launch, and
the least time the card could take for them.

Frozen copies of the counts that the hand kernels were designed against
(counted from ``csrc/chomp_cost.cu``, ``csrc/sdf_query.cu`` and
``csrc/sdf_point.cuh``).  The peaks are NVIDIA's data sheet for one H100
SXM at its 700 W limit: 67 TFLOP/s in float32 outside the tensor cores,
3.35 TB/s of HBM.
"""

from __future__ import annotations

import torch

FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12

# operations of sdf_query per (point, enabled object) pair, by part: the
# frame change (9 products, 9 sums); the analytic SDF and gradient of each
# kind (with the rounding, the penalty and the sign terms); the baked
# grid's coordinates (every pair) and its 7 four-channel lerps (in the
# volume only); the hinge, the rotation back and the masked sums
SDF_PAIR_FLOPS = dict(frame=18, box=42, sphere=33, cylinder=45, grid=21,
                      grid_lerps=112, hinge_reduce=37)

# flops of chomp_obstacle: a point's velocity and acceleration (3
# coordinates x 2 flops per non-zero entry of the two difference matrices'
# row of its timestep), its direction and cost (the norm, v^, the two
# projections, the division: 40), one Jacobian column and its dot with the
# direction per dof (16), the selection's key and compare per radix pass
# (4 passes x 4), the finger softening (8); under the quirks each (t,
# link)'s gradient point formed again
CHOMP_FLOPS = dict(band=6, point=40, dof=16, select=16, soften=8)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time of ``flops`` and ``nbytes`` on the card: the larger
    of the two at the peaks."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)


def _nonzero(m) -> int:
    return 0 if m is None else int(torch.count_nonzero(m))


def chomp_obstacle_work(args, nz: int | None = None) -> tuple:
    """(flops, bytes) of one ``chomp_obstacle`` call on ``args`` (its
    operator's arguments: x, origins, axes, x_start, x_end, pot, grad,
    collide, dmats, tables, dt, k, consider_finger, soften, quirks): each
    input read once (of the two difference matrices only the non-zero
    entries of the T rows that the derivative keeps, of the joint frames
    only the D dof joints'), each output written once.  ``nz``, the
    difference matrices' count, may be given (it reads the device)."""
    pot, dmats, tables = args[5], args[8], args[9]
    k, soften, quirks = args[11], args[13], args[14]
    t, n_links, p = pot.shape[-3:]
    rows = pot.numel() // (t * n_links * p)
    d = (tables.shape[0] - n_links) // (n_links + 2)
    if nz is None:
        nz = _nonzero(dmats[:2, :t])
    n = t * n_links * p
    per_row = (CHOMP_FLOPS["band"] * nz * n_links * p
               + n * (CHOMP_FLOPS["point"] + CHOMP_FLOPS["dof"] * d)
               + (CHOMP_FLOPS["select"] * n if 0 < k < n else 0)
               + (CHOMP_FLOPS["soften"] * n if soften else 0))
    if quirks and k:
        per_row += (CHOMP_FLOPS["band"] * nz * n_links + t * n_links * (
            CHOMP_FLOPS["point"] + CHOMP_FLOPS["dof"] * d))
    nbytes = 4 * (rows * (n * 3 + 2 * t * d * 3 + 2 * n_links * p * 3 + n
                          + n * 3 + n + t * n_links + t * d + 1)
                  + nz + tables.numel())
    return rows * per_row, nbytes


def sdf_work(scene, inv_poses, points, disables) -> tuple:
    """(operations, bytes) that one query of scene rows ``[B, ...]`` needs
    on these inputs: only enabled objects' pairs, the baked grid's
    in-volume pairs at their stencils' cost and only the grid cells those
    stencils touch (16 bytes each) read, each other input read once and
    the three outputs written once.  ``scene`` has the rows' ``kinds``
    (analytic) or ``data4`` and ``limits`` (baked)."""
    b, p = points.shape[:2]
    keep = disables <= 0                                        # [B, O]
    baked = hasattr(scene, "data4")
    ops = SDF_PAIR_FLOPS["frame"] + SDF_PAIR_FLOPS["hinge_reduce"]
    nbytes = 4 * b * p * (3 + 1 + 3 + 1) + 4 * keep.numel() * (16 + 4)
    if not baked:
        per_obj = torch.tensor([SDF_PAIR_FLOPS[k] for k in
                                ("box", "sphere", "cylinder")],
                               device=points.device)[scene.kinds.long()]
        flops = float(((ops + per_obj) * keep).sum()) * p
        return flops, nbytes + 4 * keep.numel() * 6
    flops = float(keep.sum()) * p * (ops + SDF_PAIR_FLOPS["grid"])
    cells = []
    for r in range(b):
        for o in torch.nonzero(keep[r]).flatten().tolist():
            inv = inv_poses[r, o]
            pts_obj = points[r] @ inv[:3, :3].T + inv[:3, 3]
            lim = scene.limits[r, o]
            d = lim[6:9].to(torch.int64)
            pg = (pts_obj - lim[0:3]) / (lim[3:6] - lim[0:3]) * lim[6:9]
            c0 = torch.trunc(pg - 0.5).to(torch.int64)
            inb = ((c0 >= 0) & (c0 + 1 < d)).all(-1)
            c0 = c0[inb]
            flops += float(inb.sum()) * SDF_PAIR_FLOPS["grid_lerps"]
            corners = [((c0[:, 0] + dx) * d[1] + c0[:, 1] + dy) * d[2]
                       + c0[:, 2] + dz for dx in (0, 1) for dy in (0, 1)
                       for dz in (0, 1)]
            flat = torch.unique(torch.cat(corners)) + o * (1 << 40)
            if scene.data4.stride(0):
                flat = flat + r * (1 << 48)
            cells.append(flat)
    n_cells = torch.unique(torch.cat(cells)).numel() if cells else 0
    return flops, nbytes + 40 * keep.numel() + 16 * n_cells
