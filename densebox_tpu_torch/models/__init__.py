from densebox_tpu_torch.models.convert import from_flax, init_params  # noqa: F401
from densebox_tpu_torch.models.densebox import (  # noqa: F401
    DenseBox,
    space_to_depth,
    trunk_plan,
)
