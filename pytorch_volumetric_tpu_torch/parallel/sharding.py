"""SDF queries and the collision step sharded over ``torch.distributed`` ranks.

A :class:`~torch.distributed.device_mesh.DeviceMesh` has a ``config``
dimension (data parallelism over joint configurations) and a ``point``
dimension (over query points); every table of every link is replicated.
Each rank runs the whole query on its own (config block, point block) and
its outputs are wrapped as ``DTensor``s sharded over both dimensions
(``DTensor.from_local(..., run_check=False)``), so the forward dispatches
no collective by construction.  The collision step's backward runs on the
rank's local tensors; then the joint gradient is all-reduced over the
``point`` dimension and the loss over the mesh, and nothing else crosses
ranks (``parallel.audit`` counts what a call dispatches).

Inputs arrive either as full tensors, which every rank holds and slices by
its mesh coordinates, or as ``DTensor``s on the mesh.  Each sharded
callable exposes ``program`` (the per-rank call, the tables as arguments)
and ``extra_args`` (the tables), which ``parallel.audit`` runs (the
neural query has no tables: the callable is its own program).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from pytorch_volumetric_tpu_torch.utils.batching import (
    as_float_tensor, cdiv, flatten_tensors, pad_to, resolve_device, unflatten_tensors)

CONFIG_AXIS = "config"
POINT_AXIS = "point"


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Union[int, Sequence[int], None] = None,
                     device=None, backend: Optional[str] = None) -> Tuple[int, int]:
    """Join this process to a ``torch.distributed`` world and return
    ``(rank, world_size)``.

    - With ``coordinator_address`` (``host:port``), ``num_processes`` and
      ``process_id``: ``init_process_group`` on ``tcp://{address}``.
    - Under a launcher (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` set, as
      ``torchrun`` sets them): ``env://``.
    - With neither: a no-op returning ``(0, 1)``, so library code can call
      it unconditionally (:func:`make_device_mesh` then makes a world of one
      itself).  A call after initialization is a no-op too; one whose
      explicit arguments disagree with the running world raises.

    The backend is NCCL when ``device`` is CUDA (the default) and gloo on
    ``device="cpu"``; ``backend`` names another (gloo runs CUDA tensors
    too, for several ranks on one card).  On CUDA, ``local_device_ids`` (or
    the launcher's ``LOCAL_RANK``) picks the rank's card.
    """
    explicit = coordinator_address is not None or num_processes is not None
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        if explicit and (num_processes, process_id) != (world, rank):
            raise ValueError(f"torch.distributed already runs as rank {rank} of {world}; "
                             f"asked for rank {process_id} of {num_processes}")
        return rank, world
    launcher = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if not explicit and not launcher:
        return 0, 1
    dev = resolve_device(device)
    if dev.type == "cuda":
        ids = local_device_ids if local_device_ids is not None else os.environ.get("LOCAL_RANK")
        if ids is not None:
            torch.cuda.set_device(int(ids if isinstance(ids, (int, str)) else ids[0]))
    backend = backend or _default_backend(dev)
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("init_distributed needs coordinator_address, num_processes and "
                             "process_id together")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def make_device_mesh(n_config: Optional[int] = None, n_point: Optional[int] = None,
                     device=None) -> DeviceMesh:
    """A 2D (``config``, ``point``) mesh over every rank of the world.

    Defaults: all ranks on ``config`` (configuration batches are the
    natural outermost data-parallel axis; the forward needs no
    communication).  Raises ``ValueError`` when ``n_config * n_point`` is
    not the world size.  Runs on CUDA unless ``device="cpu"``; a process
    that joined no world gets a world of one on an in-memory store (no
    port, no launcher), on NCCL for CUDA and gloo for the CPU.
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(_default_backend(dev), store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if n_config is None and n_point is None:
        n_config, n_point = n, 1
    elif n_config is None:
        n_config = n // n_point
    elif n_point is None:
        n_point = n // n_config
    if n_config * n_point != n:
        raise ValueError(f"mesh {n_config}x{n_point} != {n} ranks")
    return init_device_mesh(dev.type, (n_config, n_point),
                            mesh_dim_names=(CONFIG_AXIS, POINT_AXIS))


def _axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def pad_for_mesh(x, mesh: DeviceMesh, axis_name: str, axis: int = 0, segment: int = 1):
    """Pad ``x`` along ``axis`` (zeros) so that it splits over the mesh
    dimension ``axis_name`` into per-rank chunks that are multiples of
    ``segment`` (the coherent path's point groups must not straddle ranks).
    Returns ``(padded, original_size)``: slice outputs back with
    ``out[..., :original_size]``."""
    x = torch.as_tensor(x)
    size = x.shape[axis]
    multiple = _axis_size(mesh, axis_name) * segment
    return pad_to(x, cdiv(size, multiple) * multiple, axis=axis), size


def _placements(mesh: DeviceMesh, **by_axis: Placement) -> Tuple[Placement, ...]:
    """Placements over the mesh's dimensions: ``by_axis`` per named
    dimension, the others replicated."""
    return tuple(by_axis.get(name, Replicate()) for name in mesh.mesh_dim_names)


def _local_block(x, mesh: DeviceMesh, axes: Sequence[str], device) -> torch.Tensor:
    """This rank's rows of ``x``, whose dim 0 is split over the mesh
    dimensions ``axes`` (several: in rank order, the first outermost).  A
    full tensor is sliced by the rank's coordinates; a ``DTensor`` is
    redistributed to that layout (no communication when it already has it)."""
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError("the DTensor lives on another device mesh")
        local = x.redistribute(mesh, _placements(mesh, **{a: Shard(0) for a in axes}))
        return as_float_tensor(local.to_local(), device)
    x = as_float_tensor(x, device)
    parts, k = 1, 0
    for a in axes:
        n = _axis_size(mesh, a)
        parts, k = parts * n, k * n + mesh.get_local_rank(a)
    if x.shape[0] % parts:
        raise ValueError(f"{x.shape[0]} rows do not split evenly over the {parts}-way "
                         f"{'x'.join(axes)} mesh dimension; pad with pad_for_mesh")
    block = x.shape[0] // parts
    return x[k * block:(k + 1) * block]


def _sharded(local: torch.Tensor, mesh: DeviceMesh,
             placements: Tuple[Placement, ...]) -> DTensor:
    """``local`` as this rank's block of a ``DTensor``, with no
    communication (the blocks are even by construction)."""
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _blocks(mesh: DeviceMesh, device, q, pts):
    return (_local_block(q, mesh, (CONFIG_AXIS,), device),
            _local_block(pts, mesh, (POINT_AXIS,), device))


def sharded_robot_query(robot_sdf, mesh: DeviceMesh) -> Callable:
    """The fused FK -> per-link SDF -> min-union query
    (``RobotSDF.fused_query_fn``) with configurations sharded over
    ``config`` and points over ``point``.

    Returns ``fn(q [A, M], pts [P, 3]) -> (val [A, P], grad [A, P, 3])``,
    ``DTensor``s placed ``(Shard(0), Shard(1))``.  ``A`` must divide by the
    ``config`` size and ``P`` by the ``point`` size (pad with
    :func:`pad_for_mesh` otherwise)."""
    fn, leaves = robot_sdf.fused_query_fn()
    out = _placements(mesh, config=Shard(0), point=Shard(1))

    def program(q, pts, *tables):
        v, g = fn(*_blocks(mesh, robot_sdf.device, q, pts), *tables)
        return _sharded(v, mesh, out), _sharded(g, mesh, out)

    def run(q, pts):
        return program(q, pts, *leaves)

    run.program, run.extra_args = program, tuple(leaves)
    return run


def sharded_robot_query_coherent(robot_sdf, mesh: DeviceMesh, values_only: bool = False,
                                 seg: int = 4) -> Callable:
    """:func:`sharded_robot_query` on the brick path
    (``sdf.compose_query_coherent``) for spatially coherent points.  ``P``
    must split over ``point`` into per-rank chunks that are multiples of
    ``seg`` (4 for raster lines, or the tile size from
    ``voxel.get_coherent_tile_points``), so that point groups stay whole.
    ``values_only=True`` returns ``val`` alone, detached."""
    from pytorch_volumetric_tpu_torch.sdf import (
        coherent_fast_tables, coherent_generic_aux, compose_query_coherent)

    children = tuple(robot_sdf.sdf.sdfs)
    n_pt = _axis_size(mesh, POINT_AXIS)
    out = _placements(mesh, config=Shard(0), point=Shard(1))

    def program(q, pts, fast_tables, generic_aux):
        n = pts.shape[0]
        if n % n_pt or (n // n_pt) % seg:
            raise ValueError(
                f"coherent sharding needs the point count ({n}) to split into per-rank "
                f"chunks that are multiples of {seg} over the {n_pt}-way '{POINT_AXIS}' axis "
                f"(got chunk {n / n_pt:g}); pad with pad_for_mesh(pts, mesh, POINT_AXIS, "
                f"segment={seg}) to a multiple of {seg * n_pt}")
        q_loc, p_loc = _blocks(mesh, robot_sdf.device, q, pts)
        m, m_inv = robot_sdf._link_transforms(q_loc)
        res = compose_query_coherent(children, m, m_inv, q_loc.shape[0], p_loc,
                                     fast_tables=fast_tables, values_only=values_only,
                                     generic_aux=generic_aux, seg=seg)
        if values_only:
            return _sharded(res, mesh, out)
        return _sharded(res[0], mesh, out), _sharded(res[1], mesh, out)

    extra = (coherent_fast_tables(children), coherent_generic_aux(children))

    def run(q, pts):
        return program(q, pts, *extra)

    run.program, run.extra_args = program, extra
    return run


def sharded_neural_robot_query(model, mesh: DeviceMesh) -> Callable:
    """A learned configuration-space field (``models.ConfigSpaceNeuralSDF``)
    sharded like :func:`sharded_robot_query`: configurations over
    ``config``, points over ``point``, weights replicated.  Returns
    ``fn(q [A, M], pts [P, 3]) -> (val [A, P], grad [A, P, 3])``."""
    out = _placements(mesh, config=Shard(0), point=Shard(1))

    def run(q, pts):
        v, g = model.query(*_blocks(mesh, model.device, q, pts))
        return _sharded(v, mesh, out), _sharded(g, mesh, out)

    return run


def sharded_sdf_query(sdf, mesh: DeviceMesh) -> Callable:
    """A plain ``ObjectFrameSDF`` query with its flat point batch sharded
    over every rank of the mesh in rank order (both dimensions).  The
    SDF's big tables are passed as arguments through the
    ``raw_query_aux`` / ``raw_query_with`` protocol.  Returns ``fn(pts [P,
    3]) -> (val [P], grad [P, 3])``, ``DTensor``s placed ``(Shard(0),
    Shard(0))``."""
    leaves, spec = flatten_tensors(sdf.raw_query_aux())
    out = _placements(mesh, config=Shard(0), point=Shard(0))

    def program(pts, *aux_leaves):
        p_loc = _local_block(pts, mesh, (CONFIG_AXIS, POINT_AXIS), sdf.device)
        v, g = sdf.raw_query_with(unflatten_tensors(spec, aux_leaves), p_loc)
        return _sharded(v, mesh, out), _sharded(g, mesh, out)

    def run(pts):
        return program(pts, *leaves)

    run.program, run.extra_args = program, tuple(leaves)
    return run


def make_collision_step(robot_sdf, optimizer: Callable[[list], torch.optim.Optimizer],
                        margin: float = 0.1, mesh: Optional[DeviceMesh] = None) -> Callable:
    """A training step that moves joint configurations out of a point
    cloud: gradient descent on ``mean(relu(margin - sdf(q, pts))^2)`` over
    all ``A x P`` pairs, through FK and the SDF's analytic gradient.

    ``optimizer`` builds a ``torch.optim.Optimizer`` over a list of tensors
    (``lambda p: torch.optim.Adam(p, lr=0.05)``).  ``step.init(q)`` returns
    the optimizer state: the optimizer over this rank's own configuration
    block, so its moments are sharded with ``q``.  ``step(q [A, M], state,
    pts [P, 3]) -> (q', state, loss)``; ``state`` is updated in place.

    With a mesh, configurations shard over ``config`` and points over
    ``point``; the forward and backward run on local tensors, then the
    joint gradient is all-reduced over ``point`` and the loss over the
    mesh, and ``q'`` is a ``DTensor`` placed ``(Shard(0), Replicate())``.
    ``mesh=None`` is the unsharded step.
    """
    query_fn, leaves = robot_sdf.fused_query_fn()
    device = robot_sdf.device

    def local(x, axis):
        if mesh is None:
            return as_float_tensor(x, device)
        return _local_block(x, mesh, (axis,), device)

    def init(q):
        return optimizer([local(q, CONFIG_AXIS).detach().clone().requires_grad_(True)])

    def program(q, opt, pts, tables):
        (param,) = opt.param_groups[0]["params"]
        with torch.no_grad():
            param.copy_(local(q, CONFIG_AXIS))
        opt.zero_grad()
        val, _ = query_fn(param, local(pts, POINT_AXIS), *tables)
        loss = torch.relu(margin - val).square().sum() / (q.shape[0] * pts.shape[0])
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            # the joint gradient and the loss are partial sums over the
            # point dimension (one all-reduce for both); the loss also over
            # the configuration dimension
            packed = torch.cat([param.grad.reshape(-1), loss.reshape(1)])
            dist.all_reduce(packed, group=mesh.get_group(POINT_AXIS))
            param.grad.copy_(packed[:-1].reshape(param.shape))
            loss = packed[-1].clone()
            dist.all_reduce(loss, group=mesh.get_group(CONFIG_AXIS))
        opt.step()
        q_new = param.detach().clone()
        if mesh is not None:
            q_new = _sharded(q_new, mesh, _placements(mesh, config=Shard(0)))
        return q_new, opt, loss

    def run(q, state, pts):
        return program(q, state, pts, leaves)

    run.init, run.program, run.extra_args = init, program, (leaves,)
    return run
