"""Multi-device layer of the port: one process per device over
``torch.distributed`` (multihost.py), data and tensor parallelism of the
train step (mesh.py) and spatial (halo) parallelism of the forward
(spatial.py)."""

from densebox_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    make_sharded_train_step,
    param_shardings,
    shard_batch,
    unshard_state,
)
from densebox_tpu_torch.parallel.multihost import (  # noqa: F401
    ensure_distributed,
    is_primary,
    local_device,
)
from densebox_tpu_torch.parallel.spatial import (  # noqa: F401
    SpatialDenseBox,
    spatial_forward,
)
