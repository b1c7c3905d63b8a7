"""Mesh topology repair — the geometry-relevant part of the reference's
blender preprocessing step (``real_world/blender_process.py:53-63``),
without blender.

The reference shells out to ``bpy`` per kitchen mesh and runs three
geometry operations (the rest — split normals, edge-split modifier,
smooth shading, smart UV — are rendering cosmetics with no effect on the
SDF/collision pipeline):

  * ``remove_doubles``       -> :func:`remove_doubles` (merge vertices
    within a tolerance, drop collapsed faces)
  * implicit degenerate cull -> duplicate/zero-area faces dropped
  * ``normals_make_consistent(inside=False)`` -> :func:`orient_faces`
    (coherent winding by adjacency flood fill, then each connected
    component flipped outward by signed volume)

Pure numpy, host-side (offline asset preparation).  ``io/meshsdf.py::
process_mesh(repair=True)`` runs it ahead of voxelization, mirroring the
reference pipeline order (``real_world/process_shape.py:86-179``).

A numpy copy of ``omg_planner_tpu/io/meshrepair.py``.
"""

from __future__ import annotations

import numpy as np


def remove_doubles(verts: np.ndarray, faces: np.ndarray,
                   eps: float = 1e-6):
    """Merge vertices closer than ``eps`` (blender ``remove_doubles``)
    and drop faces that collapse (repeated vertex) or duplicate another
    face.  Returns (verts', faces')."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    # quantize to an eps grid: vertices in the same cell merge (blender
    # uses a distance threshold; grid snap is the standard O(V) variant)
    keyed = np.round(verts / max(eps, 1e-12)).astype(np.int64)
    _, first_idx, inverse = np.unique(
        keyed, axis=0, return_index=True, return_inverse=True)
    new_verts = verts[np.sort(first_idx)]
    # remap through the sorted-unique order
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    remap = rank[inverse]
    new_faces = remap[faces]
    # drop collapsed faces (any repeated vertex)
    ok = ((new_faces[:, 0] != new_faces[:, 1])
          & (new_faces[:, 1] != new_faces[:, 2])
          & (new_faces[:, 2] != new_faces[:, 0]))
    new_faces = new_faces[ok]
    # drop exact duplicate faces regardless of rotation/winding
    canon = np.sort(new_faces, axis=1)
    _, keep = np.unique(canon, axis=0, return_index=True)
    return new_verts.astype(np.float32), new_faces[np.sort(keep)]


def _edge_map(faces: np.ndarray):
    """directed edge -> list of (face, slot) for adjacency traversal."""
    edges = {}
    for f, (a, b, c) in enumerate(faces):
        for i, (u, v) in enumerate(((a, b), (b, c), (c, a))):
            edges.setdefault((min(u, v), max(u, v)), []).append((f, u < v))
    return edges


def orient_faces(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Coherent outward winding (blender
    ``normals_make_consistent(inside=False)``).

    Flood-fills each connected component flipping faces so every shared
    edge is traversed in opposite directions by its two faces (manifold
    coherence); then flips whole components whose signed volume is
    negative so normals point outward.  Non-manifold edges (>2 faces)
    keep the first-visited orientation — same best-effort as blender.
    """
    faces = np.asarray(faces, np.int64).copy()
    n = len(faces)
    if n == 0:
        return faces
    edges = _edge_map(faces)
    face_adj = [[] for _ in range(n)]
    for lst in edges.values():
        if len(lst) == 2:
            (f1, d1), (f2, d2) = lst
            face_adj[f1].append((f2, d1, d2))
            face_adj[f2].append((f1, d2, d1))

    visited = np.zeros(n, bool)
    flipped = np.zeros(n, bool)
    comp_id = np.full(n, -1)
    n_comp = 0
    for seed in range(n):
        if visited[seed]:
            continue
        stack = [seed]
        visited[seed] = True
        comp_id[seed] = n_comp
        while stack:
            f = stack.pop()
            for g, df, dg in face_adj[f]:
                if visited[g]:
                    continue
                # coherent manifold: the shared edge must run in OPPOSITE
                # effective directions — with e_f = df ^ flipped[f] the
                # requirement dg ^ flipped[g] = NOT e_f solves to
                # flipped[g] = (df == dg) ^ flipped[f]
                flipped[g] = flipped[f] ^ (df == dg)
                visited[g] = True
                comp_id[g] = n_comp
                stack.append(g)
        n_comp += 1

    out = faces.copy()
    flip_rows = np.where(flipped)[0]
    out[flip_rows] = out[flip_rows][:, ::-1]

    # outward: flip components with negative signed volume
    v = np.asarray(verts, np.float64)
    tri = v[out]  # [F, 3, 3]
    vol6 = np.einsum("fi,fi->f", tri[:, 0],
                     np.cross(tri[:, 1], tri[:, 2]))
    for c in range(n_comp):
        rows = comp_id == c
        if vol6[rows].sum() < 0:
            out[rows] = out[rows][:, ::-1]
    return out


def repair_mesh(verts: np.ndarray, faces: np.ndarray, eps: float = 1e-6):
    """remove_doubles + coherent outward winding; returns (verts, faces)
    plus a stats dict for logging."""
    v0, f0 = len(verts), len(faces)
    verts, faces = remove_doubles(verts, faces, eps)
    faces = orient_faces(verts, faces)
    stats = dict(verts_in=v0, verts_out=len(verts),
                 faces_in=f0, faces_out=len(faces))
    return verts, faces, stats


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        for a, b, c in np.asarray(faces) + 1:
            f.write(f"f {a} {b} {c}\n")
