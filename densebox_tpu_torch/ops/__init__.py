from densebox_tpu_torch.ops.decode import decode_topk  # noqa: F401
from densebox_tpu_torch.ops.nms import box_area, iou_matrix, nms  # noqa: F401
