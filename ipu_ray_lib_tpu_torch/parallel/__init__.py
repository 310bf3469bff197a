"""Data-parallel rendering over several devices and processes."""

from .mesh import (
    RayMesh,
    make_ray_mesh,
    render_path_sharded,
    render_shadow_sharded,
    render_streaming_sharded,
    shard_plan,
    shard_rays,
    shard_seeds,
)
