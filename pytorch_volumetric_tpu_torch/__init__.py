"""pytorch_volumetric_tpu_torch: the PyTorch/CUDA port of the differentiable
distance-field engine.

The flat public namespace mirrors the JAX package's for what has been
ported: batched SDF value+gradient queries on meshes, voxel-cached SDFs,
min-union composition, robot model (URDF, SDF, MJCF) -> SDF over batched
joint configurations, and chamfer metrics.  Entry points run on CUDA unless
given ``device="cpu"``; the closest-point + winding sweep is a hand-written
CUDA kernel (``csrc/closest_point.cu``).
"""

from pytorch_volumetric_tpu_torch.sdf import (
    SDFQuery, ObjectFactory, MeshObjectFactory, ObjectFrameSDF, SphereSDF,
    BoxSDF, CylinderSDF, CapsuleSDF, MeshSDF, ComposedSDF, CachedSDF,
    OutOfBoundsStrategy, aabb_corners, compose_query, pad_aabb,
    sample_mesh_points,
)
from pytorch_volumetric_tpu_torch.chamfer import (
    batch_chamfer_dist, PlausibleDiversity, PlausibleDiversityReturn,
    pairwise_distance, pairwise_distance_chamfer,
)
from pytorch_volumetric_tpu_torch.voxel import (
    VoxelGrid, GridView, get_divisible_range_by_resolution,
    get_coordinates_and_points_in_grid,
)
from pytorch_volumetric_tpu_torch.transforms import Transform3d, Translate
from pytorch_volumetric_tpu_torch.model_to_sdf import (
    RobotSDF, cache_link_sdf_factory, aabb_to_ordered_end_points,
)
from pytorch_volumetric_tpu_torch.kinematics import (
    Chain, SerialChain, build_chain_from_urdf, build_serial_chain_from_urdf,
    build_chain_from_sdf, build_serial_chain_from_sdf,
    build_chain_from_mjcf, build_serial_chain_from_mjcf,
)
from pytorch_volumetric_tpu_torch import mesh
from pytorch_volumetric_tpu_torch import transforms
from pytorch_volumetric_tpu_torch import kinematics
from pytorch_volumetric_tpu_torch import state
from pytorch_volumetric_tpu_torch.utils import robots
