from densebox_tpu_torch.models.convert import (  # noqa: F401
    from_flax,
    init_params,
    qparams_from_jax,
    state_from_jax,
)
from densebox_tpu_torch.models.densebox import (  # noqa: F401
    DenseBox,
    dropout_keep_mask,
    dropout_plan,
    fused_relu_dropout,
    space_to_depth,
    trunk_plan,
)
from densebox_tpu_torch.models.quant import (  # noqa: F401
    QuantDenseBox,
    quantize_densebox,
)
