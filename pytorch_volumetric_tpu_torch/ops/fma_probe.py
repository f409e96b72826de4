"""The FP32 multiply-add ceiling probe as a hand-written CUDA kernel.

:func:`fma_probe_cuda` runs ``csrc/fma_probe.cu`` on CUDA tensors (built at
first use) and :func:`fma_probe` on CPU tensors: every element runs 8
independent chains ``acc = acc * a + b``, 32 multiply-adds per iteration,
and returns the chains' sum.  Its rate, 2 operations per multiply-add, is
the FP32 ceiling of the sweep's roofline (``bench/sweep_roofline.py``).
``fma_probe_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_volumetric_tpu_torch.ops import cuda_build

KERNEL = "fma_probe"
CHAINS = 8
FMAS_PER_ITER = 32  # CHAINS chains x 4 rounds


def flops(n: int, iters: int) -> int:
    """FP32 operations of one call: 2 per multiply-add."""
    return 2 * FMAS_PER_ITER * iters * n


def fma_probe(x: torch.Tensor, y: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version: the same recurrence on whole tensors, the chains
    stacked as ``[8, n]`` (``benchmarks/pallas_mfu.py`` ``fma_kernel``)."""
    scale = torch.tensor([0.1 * (i + 1) for i in range(CHAINS)],
                         dtype=torch.float32, device=x.device)
    acc = x[None, :] * scale[:, None]
    for _ in range(iters * FMAS_PER_ITER // CHAINS):
        acc = acc * x + y
    out = acc[0]
    for i in range(1, CHAINS):
        out = out + acc[i]
    return out


def fma_probe_cuda(x: torch.Tensor, y: torch.Tensor, iters: int) -> torch.Tensor:
    """``x, y [n]`` float32 -> ``[n]``, :func:`fma_probe`'s function with
    fused multiply-adds (one rounding per step instead of two)."""
    if x.device.type == "cpu":
        return fma_probe(x, y, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32 or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 vector")
        if t.device != x.device or t.shape != x.shape:
            raise ValueError("x and y must have the same shape and device")
    if x.numel() >= 2 ** 31 or not 0 <= iters < 2 ** 31:
        raise ValueError("size or iteration count too large for 32-bit indexing")
    lib = cuda_build.load(KERNEL)
    fn = lib.pvt_fma_probe
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    if x.numel():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            code = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), iters,
                      stream)
        cuda_build.check_launch(lib, code, "fma_probe")
        fma_probe_cuda.launches += 1
    return out


fma_probe_cuda.launches = 0
