"""pytorch_volumetric_tpu_torch: the PyTorch/CUDA port of the differentiable
distance-field engine.

The flat public namespace mirrors the JAX package's: batched SDF
value+gradient queries on meshes, voxel-cached SDFs and voxel containers,
min-union composition (with the coherent brick-gather path for grid
sweeps), robot model (URDF, SDF, MJCF) -> SDF over batched joint
configurations, the narrow-band SDF of large meshes, chamfer metrics, SDF
slice plots and the neural SDF models distilled from exact SDFs.  Entry
points run on CUDA unless given ``device="cpu"``; the closest-point +
winding sweep (``csrc/closest_point.cu``) and the narrow-band query
(``csrc/narrow_band.cu``) are hand-written CUDA kernels.
"""

from pytorch_volumetric_tpu_torch.sdf import (
    SDFQuery, ObjectFactory, MeshObjectFactory, ObjectFrameSDF, SphereSDF,
    BoxSDF, CylinderSDF, CapsuleSDF, MeshSDF, NarrowBandMeshSDF, ComposedSDF, CachedSDF,
    OutOfBoundsStrategy, aabb_corners, compose_query, compose_query_coherent,
    pad_aabb, sample_mesh_points,
)
from pytorch_volumetric_tpu_torch.chamfer import (
    batch_chamfer_dist, PlausibleDiversity, PlausibleDiversityReturn,
    pairwise_distance, pairwise_distance_chamfer,
)
from pytorch_volumetric_tpu_torch.voxel import (
    Voxels, VoxelGrid, VoxelSet, ExpandingVoxelGrid, GridView,
    get_divisible_range_by_resolution, get_coordinates_and_points_in_grid,
    get_coherent_grid_points, get_coherent_tile_points, voxel_down_sample,
    bounds_contain_another_bounds,
)
from pytorch_volumetric_tpu_torch.volume import is_inside
from pytorch_volumetric_tpu_torch.transforms import (
    Transform3d, Translate, random_rotation, matrix_to_rotation_6d,
    euler_angles_to_matrix,
)
from pytorch_volumetric_tpu_torch.model_to_sdf import (
    RobotSDF, cache_link_sdf_factory, narrow_band_link_sdf_factory,
    aabb_to_ordered_end_points,
)
from pytorch_volumetric_tpu_torch.kinematics import (
    Chain, SerialChain, build_chain_from_urdf, build_serial_chain_from_urdf,
    build_chain_from_sdf, build_serial_chain_from_sdf,
    build_chain_from_mjcf, build_serial_chain_from_mjcf,
)
from pytorch_volumetric_tpu_torch.visualization import draw_sdf_slice, get_transformed_meshes
from pytorch_volumetric_tpu_torch import mesh
from pytorch_volumetric_tpu_torch import transforms
from pytorch_volumetric_tpu_torch import kinematics
from pytorch_volumetric_tpu_torch import state
from pytorch_volumetric_tpu_torch import models
from pytorch_volumetric_tpu_torch.models import (
    NeuralSDF, ConfigSpaceNeuralSDF, fit_neural_sdf, fit_config_space_sdf,
)
from pytorch_volumetric_tpu_torch.utils import robots
