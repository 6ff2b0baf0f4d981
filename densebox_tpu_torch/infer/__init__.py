from densebox_tpu_torch.infer.detector import (  # noqa: F401
    candidates,
    detect_batch,
    make_detect_fn,
    pyramid_shapes,
)
from densebox_tpu_torch.infer.resize import resize_linear  # noqa: F401
