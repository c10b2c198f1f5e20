from .mesh import (
    Mesh,
    Sharded,
    make_mesh,
    sharded_batch_exp_fn,
    sharded_group_ifft_fn,
    sharded_msm_fn,
    sharded_step_fn,
)
from .runtime import (
    active_mesh,
    mesh_size,
    pad_width,
    put_points,
    put_scalars,
    reset_mesh_cache,
    scalar_mul,
)

__all__ = [
    "Mesh",
    "Sharded",
    "make_mesh",
    "sharded_batch_exp_fn",
    "sharded_group_ifft_fn",
    "sharded_msm_fn",
    "sharded_step_fn",
    "active_mesh",
    "mesh_size",
    "pad_width",
    "put_points",
    "put_scalars",
    "reset_mesh_cache",
    "scalar_mul",
]
