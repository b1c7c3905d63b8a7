"""The import guard: no module of the JAX package, or of JAX, may be loaded
in a run's process; the reference may load nothing of the program."""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "omg_planner_tpu")
PROGRAM = "omg_planner_torch"


def top_level(name: str) -> str:
    """The part of a module's name before its first dot."""
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None, forbidden=FORBIDDEN) -> list:
    """The loaded modules whose top-level name is, whole, one of
    ``forbidden``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if top_level(m) in forbidden)


def imports_of(path: str) -> set:
    """Top-level names of the modules a source file imports (absolute
    imports only; relative ones stay inside its own package)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top_level(node.module))
    return out


def reference_imports(ref_dir: str) -> dict:
    """{file: forbidden top-level names it imports} over the reference's
    sources: neither JAX, the JAX package nor the program."""
    bad = {}
    for name in sorted(os.listdir(ref_dir)):
        if name.endswith(".py"):
            hit = imports_of(os.path.join(ref_dir, name)) & set(
                FORBIDDEN + (PROGRAM,))
            if hit:
                bad[name] = sorted(hit)
    return bad
