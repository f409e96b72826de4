"""Build and load the package's CUDA kernels.

Each library is one source under ``csrc/`` compiled by ``nvcc`` for Hopper
(``sm_90a``) with the shared flags plus its own, into a shared library with
a plain C interface, named after a hash of the source, the headers beside
it and all its flags, in ``_build/`` beside the package (listed in
``.gitignore``).  The build
happens at first use, or all at once through :func:`build`, which starts one
``nvcc`` per library in parallel.  Libraries are loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# library name -> (source, its own flags).  -fmad=false: no multiply-add
# contraction, so a kernel's arithmetic matches its plain PyTorch version
# operation for operation (see the notes in the sources), and a fused
# multiply-add appears only where a source writes one (fma_probe.cu).
# closest_point_fmad is the sweep's source with contraction on, built for
# the roofline probe only (bench/sweep_roofline.py).
SOURCES = {
    "closest_point": ("closest_point.cu", ("-fmad=false",)),
    "narrow_band": ("narrow_band.cu", ("-fmad=false",)),
    "coherent_union": ("coherent_union.cu", ("-fmad=false",)),
    "coherent_union_tri": ("coherent_union_tri.cu", ("-fmad=false",)),
    "fk": ("fk.cu", ("-fmad=false",)),
    "closest_point_mma": ("closest_point_mma.cu", ("-fmad=false",)),
    "fma_probe": ("fma_probe.cu", ("-fmad=false",)),
    "closest_point_fmad": ("closest_point.cu", ("-fmad=true",)),
}

# shared by every library; -Xptxas=-v reports registers and shared memory
# per kernel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + SOURCES[name][1]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ at first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    """The library's path, named after a hash of its source, every header
    under ``csrc/`` (a source may include any of them) and its flags."""
    digest = hashlib.sha1(" ".join(_flags(name)).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith((".cuh", ".h")))
    for fname in [SOURCES[name][0]] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[float, str]]:
    """Compile every named library that is missing, one ``nvcc`` per
    library, all started together.  Returns ``{name: (seconds, compiler
    output)}`` for the libraries it built; raises if any build fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        # -I: a copy of a source elsewhere (scripts/sweep_variants_torch.py)
        # still finds the headers under csrc/
        cmd = [nvcc, *_flags(n), "-I", CSRC_DIR, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    results, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n} ({SOURCES[n][0]}):\n{log}")
            continue
        os.replace(tmp, out)
        results[n] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        lib.pvt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pvt_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.pvt_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")
