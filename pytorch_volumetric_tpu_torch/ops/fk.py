"""A robot's link transforms from its joint configurations as hand-written
CUDA kernels, forward and d/dq.

:func:`fk_link_transforms` is the drop-in equivalent of the plain chain
walk :func:`link_transforms_plain` (``kinematics.Chain.fk_matrices``, then
each SDF link's ``offset^-1 o FK(link)^-1`` and its inverse, which
``RobotSDF._link_transforms`` runs for any ``q`` but a float32 CUDA one):
``q [A, M]`` -> link-major ``(obj->link [L*A, 4, 4], link->obj [L*A, 4,
4])``.
For CUDA tensors it launches ``csrc/fk.cu`` once on PyTorch's current
stream (the library is built from ``csrc/`` at first use), and its backward
launches the d/dq kernel once; neither waits for the device.  Launches are
counted in ``utils.profiling.COUNTERS["kernel.fk_link_transforms"]`` and
``["kernel.fk_link_transforms_backward"]``.  For CPU tensors both run the
plain walk (:func:`link_transforms_plain`) and its vector-Jacobian product.

The chain reaches the kernels as a :class:`FKDescriptor`: device tensors
of the tree's frames in topological order and of the SDF links, built once
for a robot and a device (:func:`fk_descriptor`), so a call copies nothing
from the host.  The op ``pvt::fk_link_transforms`` takes ``q`` and the
descriptor's tensors, so ``torch.export`` keeps FK as one opaque node whose
registered backward (``pvt::fk_link_transforms_backward``) keeps a loaded
program differentiable w.r.t. ``q``.  The backward op has no derivative of
its own: a second derivative through FK (``create_graph=True``, then a
gradient of the result w.r.t. ``q``) raises PyTorch's "no autograd formula
was registered" error instead of giving a number.  The plain walk on the CPU
keeps second derivatives.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from pytorch_volumetric_tpu_torch import transforms as tfm
from pytorch_volumetric_tpu_torch.ops import cuda_build
from pytorch_volumetric_tpu_torch.utils import profiling

KERNEL = "fk"
_FORWARD, _BACKWARD = "pvt_fk_forward", "pvt_fk_backward"
_p, _i = ctypes.c_void_p, ctypes.c_int

# a frame's joint kind (column 1 of FKDescriptor.frames); a joint that is
# not actuated (fixed, floating, planar, ...) only applies its origin
FIXED, REVOLUTE, PRISMATIC = 0, 1, 2
# flags (column 3): the joint mimics its master, the motion is conjugated by
# a joint offset, the frame has no joint (its world matrix is its parent's,
# the identity at the root).  The root is a frame like any other: a root
# with a joint (a serial chain cut below the tree's root) applies its origin
# and motion to the identity, as ``Chain.fk_matrices`` does.
MIMIC, JOINT_OFFSET, NO_JOINT = 1, 2, 4


class FKDescriptor(NamedTuple):
    """A kinematic tree and its SDF links as tensors, frames in topological
    order (a parent before its children; the root first)."""
    frames: torch.Tensor         # [F, 4] int32: parent (-1 at the root), kind, q index, flags
    origins: torch.Tensor        # [F, 4, 4] float32: the joint's origin (identity without one)
    axes: torch.Tensor           # [F, 3] float32: the joint's unit axis
    joint_offsets: torch.Tensor  # [F, 2, 4, 4] float32: the joint offset and its inverse
    mimic: torch.Tensor          # [F, 2] float64: multiplier and offset of a mimic joint
    link_frames: torch.Tensor    # [L] int32: each SDF link's frame
    offset_inv: torch.Tensor     # [L, 4, 4] float32: each SDF link's inverse visual offset


def fk_descriptor(chain, link_frame_names: Sequence[str],
                  offset_inv: torch.Tensor) -> FKDescriptor:
    """The descriptor of ``chain`` (a ``kinematics.Chain``) with SDF links
    at the frames ``link_frame_names`` and inverse visual offsets
    ``offset_inv [L, 4, 4]``, on ``offset_inv``'s device.
    It holds the very values the plain walk reads (the chain's float32
    origins, axes and joint offsets, the mimic joints' Python floats), so
    the walk over it is the plain walk's arithmetic."""
    frames = chain._ordered
    index = {f.name: k for k, f in enumerate(frames)}
    parents = {c.name: index[f.name] for f in frames for c in f.children}
    jidx = {n: k for k, n in enumerate(chain.get_joint_parameter_names())}
    origins, axes, offsets = chain._static
    rows, mimic, joffs = [], [], []
    eye = torch.eye(4)
    for f in frames:
        j = f.joint
        kind, src, flags, mult_off = FIXED, -1, NO_JOINT if j is None else 0, (1.0, 0.0)
        if j is not None and j.joint_type in ("revolute", "continuous", "prismatic"):
            kind = PRISMATIC if j.joint_type == "prismatic" else REVOLUTE
            mim = chain._mimic.get(j.name)
            if mim is not None:
                src, flags, mult_off = jidx[mim[0]], MIMIC, mim[1:]
            else:
                src = jidx[j.name]
            if f.name in offsets:
                flags |= JOINT_OFFSET
        rows.append((parents.get(f.name, -1), kind, src, flags))
        mimic.append(mult_off)
        joffs.append(torch.stack([t.cpu() for t in offsets[f.name]])
                     if f.name in offsets else torch.stack([eye, eye]))
    cpu = dict(
        frames=torch.tensor(rows, dtype=torch.int32).reshape(len(frames), 4),
        origins=torch.stack([origins[f.name].cpu() for f in frames]),
        axes=torch.stack([axes[f.name].cpu() for f in frames]),
        joint_offsets=torch.stack(joffs),
        mimic=torch.tensor(mimic, dtype=torch.float64).reshape(len(frames), 2),
        link_frames=torch.tensor([index[n] for n in link_frame_names], dtype=torch.int32),
        offset_inv=offset_inv.detach().cpu())
    return FKDescriptor(**{k: v.contiguous().to(offset_inv.device) for k, v in cpu.items()})


def link_transforms_plain(q: torch.Tensor, frames: torch.Tensor, origins: torch.Tensor,
                          axes: torch.Tensor, joint_offsets: torch.Tensor,
                          mimic: torch.Tensor, link_frames: torch.Tensor,
                          offset_inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``Chain.fk_matrices`` over the descriptor,
    operation for operation, then each SDF link's ``offset^-1 o
    FK(link)^-1`` and its inverse; differentiable by autograd (second
    derivatives too)."""
    batch = q.shape[:-1]
    mim = mimic.tolist()
    world: List[torch.Tensor] = []
    eye = torch.eye(4, dtype=q.dtype, device=q.device).expand(batch + (4, 4))
    for f, (parent, kind, src, flags) in enumerate(frames.tolist()):
        m = eye if parent < 0 else world[parent]
        if flags & NO_JOINT:
            world.append(m)
            continue
        m = tfm.mm(m, origins[f])
        if kind != FIXED:
            qi = mim[f][0] * q[..., src] + mim[f][1] if flags & MIMIC else q[..., src]
            if kind == REVOLUTE:
                motion = tfm.make_tf(rot=tfm.axis_angle_to_matrix(axes[f], qi))
            else:
                motion = tfm.make_tf(pos=axes[f] * qi[..., None])
            if flags & JOINT_OFFSET:
                motion = tfm.mm(tfm.mm(joint_offsets[f, 0], motion), joint_offsets[f, 1])
            m = tfm.mm(m, motion)
        world.append(m)
    mats = [tfm.mm(offset_inv[i], tfm.invert_tf(world[fr]))
            for i, fr in enumerate(link_frames.tolist())]
    m = torch.cat(mats, dim=0)
    return m, tfm.invert_tf(m)


def _entry():
    lib = cuda_build.load(KERNEL)
    fwd, bwd = getattr(lib, _FORWARD), getattr(lib, _BACKWARD)
    if fwd.argtypes is None:
        # q, A, M, frames, F, origins, axes, joint_offsets, mimic, link_frames, L,
        # offset_inv, then the forward's (world, m, m_inv) or the backward's
        # (g_m, g_minv, scratch, dq), then the stream
        head = [_p, _i, _i, _p, _i, _p, _p, _p, _p, _p, _i, _p]
        fwd.argtypes = head + [_p, _p, _p, _p]
        bwd.argtypes = head + [_p, _p, _p, _p, _p]
        fwd.restype = bwd.restype = ctypes.c_int
    return lib, fwd, bwd


def _check(q: torch.Tensor, desc: Sequence[torch.Tensor],
           cotangents: Sequence[torch.Tensor] = ()) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    if q.dim() != 2 or q.dtype != torch.float32:
        raise ValueError(f"q must be [A, M] float32, got {tuple(q.shape)} {q.dtype}")
    frames, origins, axes, joint_offsets, mimic, link_frames, offset_inv = desc
    F, L, A = frames.shape[0], link_frames.shape[0], q.shape[0]
    want = ((frames, (F, 4), torch.int32), (origins, (F, 4, 4), torch.float32),
            (axes, (F, 3), torch.float32), (joint_offsets, (F, 2, 4, 4), torch.float32),
            (mimic, (F, 2), torch.float64), (link_frames, (L,), torch.int32),
            (offset_inv, (L, 4, 4), torch.float32))
    want += tuple((g, (L * A, 4, 4), torch.float32) for g in cotangents)
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"an input is {tuple(t.shape)} {t.dtype}, want {shape} {dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"every input must be contiguous on {q.device}")
    if A * max(q.shape[1], 1) >= 2 ** 31:
        raise ValueError("A * M must fit 32 bits")


def _head(q: torch.Tensor, desc: Sequence[torch.Tensor]) -> list:
    frames, origins, axes, joint_offsets, mimic, link_frames, offset_inv = desc
    return [q.data_ptr(), q.shape[0], q.shape[1], frames.data_ptr(), frames.shape[0],
            origins.data_ptr(), axes.data_ptr(), joint_offsets.data_ptr(), mimic.data_ptr(),
            link_frames.data_ptr(), link_frames.shape[0], offset_inv.data_ptr()]


def _fk_op_cuda(q: torch.Tensor, frames: torch.Tensor, origins: torch.Tensor,
                axes: torch.Tensor, joint_offsets: torch.Tensor, mimic: torch.Tensor,
                link_frames: torch.Tensor, offset_inv: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: one launch, no host synchronisation."""
    desc = (frames, origins, axes, joint_offsets, mimic, link_frames, offset_inv)
    _check(q, desc)
    A, F, L = q.shape[0], frames.shape[0], link_frames.shape[0]
    m = torch.empty((L * A, 4, 4), dtype=torch.float32, device=q.device)
    m_inv = torch.empty_like(m)
    if A and L:
        lib, fwd, _ = _entry()
        world = torch.empty((F, 16, A), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            code = fwd(*_head(q, desc), world.data_ptr(), m.data_ptr(), m_inv.data_ptr(),
                       torch.cuda.current_stream(q.device).cuda_stream)
        cuda_build.check_launch(lib, code, _FORWARD)
        profiling.count("kernel.fk_link_transforms")
    return m, m_inv


fk_link_transforms_op = torch.library.custom_op(
    "pvt::fk_link_transforms", _fk_op_cuda, mutates_args=(), device_types="cuda")


@fk_link_transforms_op.register_kernel("cpu")
def _fk_op_cpu(q, frames, origins, axes, joint_offsets, mimic, link_frames, offset_inv):
    return link_transforms_plain(q, frames, origins, axes, joint_offsets, mimic, link_frames,
                                 offset_inv)


@fk_link_transforms_op.register_fake
def _fk_op_fake(q, frames, origins, axes, joint_offsets, mimic, link_frames, offset_inv):
    n = link_frames.shape[0] * q.shape[0]
    return q.new_empty((n, 4, 4)), q.new_empty((n, 4, 4))


def _fk_backward_cuda(g_m: torch.Tensor, g_minv: torch.Tensor, q: torch.Tensor,
                      frames: torch.Tensor, origins: torch.Tensor, axes: torch.Tensor,
                      joint_offsets: torch.Tensor, mimic: torch.Tensor,
                      link_frames: torch.Tensor, offset_inv: torch.Tensor) -> torch.Tensor:
    """``dq [A, M]`` from the cotangents of both outputs: the d/dq kernel,
    one launch (none when ``A * M`` is 0)."""
    desc = (frames, origins, axes, joint_offsets, mimic, link_frames, offset_inv)
    _check(q, desc, (g_m, g_minv))
    A, M, F = q.shape[0], q.shape[1], frames.shape[0]
    dq = torch.empty((A, M), dtype=torch.float32, device=q.device)
    if A * M:
        lib, _, bwd = _entry()
        scratch = torch.empty((F, 32, A * M), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            code = bwd(*_head(q, desc), g_m.data_ptr(), g_minv.data_ptr(), scratch.data_ptr(),
                       dq.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
        cuda_build.check_launch(lib, code, _BACKWARD)
        profiling.count("kernel.fk_link_transforms_backward")
    return dq


fk_link_transforms_backward_op = torch.library.custom_op(
    "pvt::fk_link_transforms_backward", _fk_backward_cuda, mutates_args=(),
    device_types="cuda")


@fk_link_transforms_backward_op.register_kernel("cpu")
def _fk_backward_cpu(g_m, g_minv, q, frames, origins, axes, joint_offsets, mimic,
                     link_frames, offset_inv):
    """The plain walk's vector-Jacobian product (``torch.func.vjp``: inside
    an op's kernel autograd records nothing)."""
    desc = (frames, origins, axes, joint_offsets, mimic, link_frames, offset_inv)
    _, vjp = torch.func.vjp(lambda x: link_transforms_plain(x, *desc), q)
    (dq,) = vjp((g_m, g_minv))
    return dq


@fk_link_transforms_backward_op.register_fake
def _fk_backward_fake(g_m, g_minv, q, *desc):
    return torch.empty_like(q)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g_m, g_minv):
    q, *desc = ctx.saved_tensors
    dq = fk_link_transforms_backward_op(g_m.contiguous(), g_minv.contiguous(), q, *desc)
    return (dq,) + (None,) * len(desc)


fk_link_transforms_op.register_autograd(_backward, setup_context=_setup)


def fk_link_transforms(q: torch.Tensor, desc: FKDescriptor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q [A, M]`` -> link-major ``(obj->link [L*A, 4, 4], link->obj
    [L*A, 4, 4])`` of the robot ``desc`` describes (on ``q``'s device),
    differentiable w.r.t. ``q`` (once: see the module's notes)."""
    return fk_link_transforms_op(q.contiguous(), *desc)
