"""The distributed layer: the (data, space, time) mesh of ranks on
``torch.distributed``, its layouts and its collectives
(``parallel.collectives``, imported from there as in the JAX package)."""

from dmd_era5_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_SPACE,
    AXIS_TIME,
    MESH_AXES,
    Mesh,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    mesh_from_config,
    parse_mesh_shape,
    single_device_mesh,
)
from dmd_era5_tpu_torch.parallel.sharding import (
    Layout,
    assemble_rows,
    col_sharded,
    grid_sharded,
    pad_rows_to_multiple,
    replicated,
    reshard,
    row_sharded,
    shard_rows,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_SPACE",
    "AXIS_TIME",
    "MESH_AXES",
    "Mesh",
    "initialize_distributed",
    "make_hybrid_mesh",
    "make_mesh",
    "mesh_from_config",
    "parse_mesh_shape",
    "single_device_mesh",
    "Layout",
    "replicated",
    "row_sharded",
    "col_sharded",
    "grid_sharded",
    "pad_rows_to_multiple",
    "shard_rows",
    "reshard",
    "assemble_rows",
]
