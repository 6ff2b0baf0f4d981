from densebox_tpu_torch.utils.logging import MetricsLogger  # noqa: F401
