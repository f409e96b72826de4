from pytorch_volumetric_tpu_torch.parallel.sharding import (
    CONFIG_AXIS, POINT_AXIS, init_distributed, make_device_mesh, pad_for_mesh,
    sharded_robot_query, sharded_robot_query_coherent, sharded_sdf_query,
    sharded_neural_robot_query, make_collision_step,
)
from pytorch_volumetric_tpu_torch.parallel.triangle_sharded import TriangleShardedMeshSDF
from pytorch_volumetric_tpu_torch.parallel.audit import (
    COLLECTIVE_OPS, count_collectives, optimized_hlo, audit_sharded_callable,
    assert_collectives,
)
