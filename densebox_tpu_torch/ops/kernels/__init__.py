"""Hand-written CUDA kernels (sources in densebox_tpu_torch/csrc), each with
its plain PyTorch version beside its wrapper and a launch counter."""
