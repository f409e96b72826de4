"""ctypes bindings for the host-side geometry runtime (``pvt_native.cpp``:
C++ BVH, fast winding number, narrow-band candidate tables, OBJ parser).

The library is compiled with ``g++`` at first use into ``_build/`` beside
the package (listed in ``.gitignore``), named after a hash of the source and
the flags, as ``ops.cuda_build`` names the CUDA libraries.  A failed build
raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from pytorch_volumetric_tpu_torch.ops.cuda_build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pvt_native.cpp")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def library_path() -> str:
    """The library's path, named after a hash of the source and the flags."""
    digest = hashlib.sha1(" ".join(FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libpvt_native_{digest.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native runtime is built from "
                           "native/pvt_native.cpp at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *FLAGS, "-o", tmp, _SRC], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for native/pvt_native.cpp:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The native library, built first if needed."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.pvt_scene_create.restype = ctypes.c_void_p
        lib.pvt_scene_create.argtypes = [_f32p, ctypes.c_int64]
        lib.pvt_scene_destroy.argtypes = [ctypes.c_void_p]
        lib.pvt_closest_query.argtypes = [
            ctypes.c_void_p, _f32p, ctypes.c_int64, _f32p, _f32p, _i32p, _f32p,
            ctypes.c_float]
        lib.pvt_build_cell_table.restype = ctypes.c_int64
        lib.pvt_build_cell_table.argtypes = [
            _f32p, ctypes.c_int64, _f32p, _f32p, _i32p, _f32p, _i32p, ctypes.c_int64,
            _i32p]
        lib.pvt_parse_obj.restype = ctypes.c_int
        lib.pvt_parse_obj.argtypes = [ctypes.c_char_p, _f32p, _i64p, _i32p, _i64p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the runtime can be built here (a ``g++`` on the path) or was
    built already."""
    return _lib is not None or os.path.exists(library_path()) or shutil.which("g++") is not None


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


class NativeScene:
    """BVH-accelerated host-side closest-point and winding queries."""

    def __init__(self, triangles: np.ndarray):
        """``triangles``: [F, 3, 3] float32 corner coordinates."""
        tris = np.ascontiguousarray(triangles, dtype=np.float32)
        self.num_faces = len(tris)
        if self.num_faces == 0:
            raise ValueError("cannot build a scene from an empty mesh (no faces)")
        self._lib = get_lib()
        self._handle = self._lib.pvt_scene_create(_ptr(tris, _f32p), self.num_faces)
        if not self._handle:
            raise RuntimeError("native scene construction failed")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.pvt_scene_destroy(self._handle)

    def closest_query(self, points: np.ndarray, winding_beta: float = 2.0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """``(dist [N] unsigned, closest [N, 3], fid [N] int32, winding
        [N])``, the contract of ``ops.point_triangle.mesh_closest_query``."""
        pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
        n = len(pts)
        closest = np.empty((n, 3), dtype=np.float32)
        dist = np.empty((n,), dtype=np.float32)
        fid = np.empty((n,), dtype=np.int32)
        wind = np.empty((n,), dtype=np.float32)
        self._lib.pvt_closest_query(self._handle, _ptr(pts, _f32p), n, _ptr(closest, _f32p),
                                    _ptr(dist, _f32p), _ptr(fid, _i32p), _ptr(wind, _f32p),
                                    ctypes.c_float(winding_beta))
        return dist, closest, fid, wind


def build_cell_table(triangles: np.ndarray, lo: np.ndarray, res: np.ndarray,
                     dims: np.ndarray, radius: np.ndarray,
                     max_k: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell candidate triangle lists for narrow-band SDF grids.

    ``radius [C]``: candidate radius per cell (< 0 skips the cell).  Returns
    ``(ids [C, K] int32, ascending in each cell and padded with -1,
    counts [C] int32)``, ``K`` the largest candidate count capped at
    ``max_k``.
    """
    lib = get_lib()
    tris = np.ascontiguousarray(triangles, dtype=np.float32)
    lo = np.ascontiguousarray(lo, dtype=np.float32)
    res = np.ascontiguousarray(res, dtype=np.float32)
    dims = np.ascontiguousarray(dims, dtype=np.int32)
    radius = np.ascontiguousarray(radius, dtype=np.float32)
    C = int(np.prod(dims.astype(np.int64)))
    counts = np.zeros(C, dtype=np.int32)
    args = (_ptr(tris, _f32p), len(tris), _ptr(lo, _f32p), _ptr(res, _f32p),
            _ptr(dims, _i32p), _ptr(radius, _f32p))
    k = int(min(lib.pvt_build_cell_table(*args, None, 0, _ptr(counts, _i32p)), max_k))
    if k == 0:
        return np.full((C, 1), -1, dtype=np.int32), counts
    ids = np.empty((C, k), dtype=np.int32)
    lib.pvt_build_cell_table(*args, _ptr(ids, _i32p), k, _ptr(counts, _i32p))
    return ids, np.minimum(counts, k)


def parse_obj_native(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Two-pass OBJ parse: ``(vertices [V, 3] float32, faces [F, 3]
    int32)``, polygons fan-triangulated; raises if the file cannot be
    read."""
    lib = get_lib()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    if lib.pvt_parse_obj(path.encode(), None, ctypes.byref(nv), None, ctypes.byref(nf)):
        raise OSError(f"cannot read {path}")
    vertices = np.empty((nv.value, 3), dtype=np.float32)
    faces = np.empty((nf.value, 3), dtype=np.int32)
    if lib.pvt_parse_obj(path.encode(), _ptr(vertices, _f32p), ctypes.byref(nv),
                         _ptr(faces, _i32p), ctypes.byref(nf)):
        raise OSError(f"cannot read {path}")
    return vertices, faces
