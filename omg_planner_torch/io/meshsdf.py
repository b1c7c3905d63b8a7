"""ctypes binding for the native mesh->SDF voxelizer (``native/meshsdf.cpp``,
shared with the JAX package and not ported); a copy of
``omg_planner_tpu/io/meshsdf.py``.

Replaces the reference's offline shape pipeline, which shells out to the
external SDFGen / meshlab / blender binaries
(``real_world/gen_sdf.py:13-56``, ``gen_xyz.py:49-75``).  The shared
library is built on first use with the system g++ into
``build/omg_meshsdf/``, named by the digest of the source and the flags
and moved into place with an atomic rename, so concurrent processes never
write one file and ``native/`` stays untouched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..ops.sdf import SignedDensityField

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "meshsdf.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "omg_meshsdf")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_LIB = None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmeshsdf_{digest.hexdigest()[:16]}.so")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _lib_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC, "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.mesh_sdf.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int, f32p, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int]
    lib.mesh_sdf.restype = None
    lib.mesh_surface_points.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int, f32p, ctypes.c_int]
    lib.mesh_surface_points.restype = ctypes.c_int
    lib.mesh_convex_decompose.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, f32p, ctypes.c_int]
    lib.mesh_convex_decompose.restype = ctypes.c_int
    _LIB = lib
    return lib


def load_obj(path: str, with_uv: bool = False):
    """Minimal wavefront .obj parser: returns (verts [V,3] f32,
    faces [F,3] i32).  Polygons are fan-triangulated.

    ``with_uv=True`` additionally returns per-corner texture coordinates
    ``face_uv [F, 3, 2]`` (or ``None`` when the file has no ``vt`` records)
    for the software rasterizer's textured path — per-corner instead of
    per-vertex so seam vertices need no duplication."""
    verts, faces, uvs, face_uv = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                vals = [float(x) for x in line.split()[1:3]]
                uvs.append(vals + [0.0] * (2 - len(vals)))
            elif line.startswith("f "):
                toks = [tok.split("/") for tok in line.split()[1:]]
                idx = [int(t[0]) - 1 for t in toks]
                ti = [int(t[1]) - 1 if len(t) > 1 and t[1] else -1
                      for t in toks]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
                    face_uv.append([ti[0], ti[i], ti[i + 1]])
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    if not with_uv:
        return verts, faces
    if not uvs or not faces.size:
        return verts, faces, None
    uvs = np.asarray(uvs, np.float32)
    fuv = np.asarray(face_uv, np.int32)
    if (fuv < 0).any():
        return verts, faces, None
    return verts, faces, uvs[fuv]


def mesh_to_sdf(verts: np.ndarray, faces: np.ndarray,
                delta: float | None = None, padding: int = 20,
                target_dim: int = 64, n_threads: int = 0
                ) -> SignedDensityField:
    """Voxelize a triangle mesh into a SignedDensityField.

    Grid sizing follows the reference convention (``gen_sdf.py:39-56``):
    cell size from the mesh extent and a target dimension, plus ``padding``
    cells on every side.
    """
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    lo = verts.min(0)
    hi = verts.max(0)
    if delta is None:
        delta = float((hi - lo).max()) / target_dim
    dims = np.ceil((hi - lo) / delta).astype(int) + 2 * padding
    origin = (lo - padding * delta).astype(np.float32)
    out = np.empty(tuple(dims), np.float32)
    lib.mesh_sdf(verts, len(verts), faces, len(faces), origin,
                 np.float32(delta), int(dims[0]), int(dims[1]), int(dims[2]),
                 out, int(n_threads))
    return SignedDensityField(out, origin.astype(np.float64), delta)


def surface_points(verts: np.ndarray, faces: np.ndarray,
                   max_points: int = 2000) -> np.ndarray:
    """Surface point samples (collision/attachment points; replaces
    ``gen_xyz.py``)."""
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    out = np.empty((max_points, 3), np.float32)
    n = lib.mesh_surface_points(verts, len(verts), faces, len(faces), out,
                                max_points)
    return out[:n]


def convex_decompose(verts: np.ndarray, faces: np.ndarray,
                     voxel: float = 0.01, max_pieces: int = 64,
                     n_threads: int = 0) -> np.ndarray:
    """Approximate convex decomposition (the reference shells out to
    testVHACD, ``real_world/gen_convex_shape.py:15-50``): voxelize the
    interior and cover it with maximal axis-aligned boxes.

    Returns [K, 6] (center xyz, half extents) in mesh coordinates — the
    pieces a physics compound collision shape consumes.  ``voxel``
    coarsens automatically until the piece count fits ``max_pieces``.
    """
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    out = np.empty((max_pieces, 6), np.float32)
    for _ in range(6):
        n = lib.mesh_convex_decompose(
            verts, len(verts), faces, len(faces), np.float32(voxel),
            max_pieces, out, int(n_threads))
        if n >= 0:
            return out[:n].copy()
        voxel *= 1.6
    raise RuntimeError("convex decomposition did not converge "
                       f"(> {max_pieces} pieces even at voxel={voxel:.3f})")


def save_compound_obj(path: str, boxes: np.ndarray):
    """Write box pieces as a grouped wavefront OBJ — one convex group per
    piece, the format physics loaders (and the reference's VHACD output)
    consume."""
    with open(path, "w") as f:
        f.write("# approximate convex decomposition (box pieces)\n")
        vi = 1
        for gi, (cx, cy, cz, hx, hy, hz) in enumerate(np.asarray(boxes)):
            f.write(f"g piece_{gi}\n")
            for sx in (-1, 1):
                for sy in (-1, 1):
                    for sz in (-1, 1):
                        f.write(f"v {cx + sx * hx:.6f} {cy + sy * hy:.6f} "
                                f"{cz + sz * hz:.6f}\n")
            for a, b, c, d in ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                               (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)):
                f.write(f"f {vi + a} {vi + b} {vi + c} {vi + d}\n")
            vi += 8
    return path


def process_mesh(path: str, out_dir: str | None = None,
                 convex: bool = False, repair: bool = False, **kw):
    """Full per-mesh asset generation (reference ``process_shape.py:86-179``):
    SDF volume + surface points + extents, persisted next to the mesh;
    ``convex=True`` additionally writes ``<base>_convex.obj`` piece hulls
    (the VHACD step of the reference pipeline); ``repair=True`` runs
    topology repair first (the blender step, ``io/meshrepair.py``) and
    also writes ``<base>.processed.obj`` like
    ``real_world/blender_process.py:21`` — downstream outputs keep the
    ORIGINAL base name."""
    verts, faces = load_obj(path)
    if repair:
        from .meshrepair import repair_mesh, save_obj

        verts, faces, stats = repair_mesh(verts, faces)
        save_obj(os.path.splitext(path)[0] + ".processed.obj", verts,
                 faces)
        print(f"repair: verts {stats['verts_in']}->{stats['verts_out']} "
              f"faces {stats['faces_in']}->{stats['faces_out']}")
    sdf = mesh_to_sdf(verts, faces, **kw)
    pts = surface_points(verts, faces)
    extents = verts.max(0) - verts.min(0)
    out_dir = out_dir or os.path.dirname(path)
    base = os.path.splitext(os.path.basename(path))[0]
    sdf.dump(os.path.join(out_dir, base + "_chomp.pkl"))
    np.savetxt(os.path.join(out_dir, base + ".xyz"), pts)
    np.savetxt(os.path.join(out_dir, base + ".extent.txt"), extents[None])
    if convex:
        boxes = convex_decompose(verts, faces,
                                 voxel=float(extents.max()) / 24)
        save_compound_obj(os.path.join(out_dir, base + "_convex.obj"),
                          boxes)
    return sdf, pts, extents
