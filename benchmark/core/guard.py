"""What the benchmark may not load.

At run time (`loaded_banned`): no module whose top-level name, the part
before the first dot, is one of BANNED. The port, `gator_tpu_torch`, is
allowed: names are compared whole, never by prefix.

Statically (`reference_imports`): the plain reference under
benchmark/reference/ imports none of BANNED and not the port either.
"""
from __future__ import annotations

import ast
import os
import os.path as osp
import sys
from typing import Iterable, List, Tuple

BANNED = ("jax", "jaxlib", "flax", "optax", "gator_tpu")
PROGRAM = "gator_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_banned(names: Iterable[str] = None) -> List[str]:
    """The module names (of sys.modules by default) whose top-level name
    is banned."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if top_level(n) in BANNED)


def imports_of(path: str) -> List[str]:
    """Absolute module names a Python file imports (relative imports are
    left out: they stay inside its package)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


def reference_imports(ref_dir: str) -> List[Tuple[str, str]]:
    """(file, module) pairs under ref_dir that import a banned name or the
    program."""
    bad = set(BANNED) | {PROGRAM}
    hits = []
    for fn in sorted(os.listdir(ref_dir)):
        if fn.endswith(".py"):
            path = osp.join(ref_dir, fn)
            hits += [(fn, m) for m in imports_of(path)
                     if top_level(m) in bad]
    return hits
