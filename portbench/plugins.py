"""Code the benchmark finds by name: ``<kind>/<name>.py`` under the
benchmark's folder, loaded once a path.

The kinds are ``metrics`` (a per-layer or end-to-end reader), ``entries``
(the program's entry a mix names), ``robots`` (the writer of a robot kind),
``meshes`` (a mesh generator) and ``links`` (a kind of link SDF: how the
program builds it and how the reference works it out again).  A later
change adds a kind's member as a new file and edits none.
"""

from __future__ import annotations

import importlib.util
import os
from types import ModuleType
from typing import Dict

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))

_loaded: Dict[str, ModuleType] = {}


def load(kind: str, name: str, base: str = BENCH_DIR) -> ModuleType:
    path = os.path.join(base, kind, f"{name}.py")
    if path not in _loaded:
        if not os.path.exists(path):
            raise KeyError(f"no {kind} named {name!r} (looked for {path})")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]
