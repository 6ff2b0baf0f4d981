from densebox_tpu_torch.data.patches import sample_patches  # noqa: F401
from densebox_tpu_torch.data.synthetic import synthetic_batch  # noqa: F401
