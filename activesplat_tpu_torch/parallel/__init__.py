"""Multi-device sharding of the render and the mapping step (counterpart of
activesplat_tpu/parallel)."""

from activesplat_tpu_torch.parallel.sharded import (  # noqa: F401
    make_render_mesh,
    render_sharded,
    sharded_mapping_step,
)
