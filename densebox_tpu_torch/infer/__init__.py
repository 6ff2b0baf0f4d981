from densebox_tpu_torch.infer.detector import (  # noqa: F401
    candidates,
    decode_landmarks,
    decode_landmarks_selected,
    detect_batch,
    detect_from_maps,
    lm_scale_select,
    make_detect_fn,
    pyramid_maps,
    pyramid_shapes,
    resolved_lm_dtype,
)
from densebox_tpu_torch.infer.resize import resize_linear  # noqa: F401
