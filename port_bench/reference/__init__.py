"""The plain reference of the DenseBox detector: plain PyTorch, float32
with TF32 off, exact integer arithmetic for the int8 convolutions. It
imports nothing of ``densebox_tpu_torch`` (nor of the JAX package): what
the port derives from the benchmark's weights and images (the int8
calibration, the quantised weights) is worked out here again."""
