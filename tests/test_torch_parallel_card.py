"""The multi-device layer on the card (marker ``gpu``; skips without one).
Imports no jax, so that it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_parallel_card.py
"""

import pytest
import torch
import torch.distributed as dist

from densebox_tpu_torch.models import DenseBox
from densebox_tpu_torch.parallel import make_mesh, make_sharded_train_step
from densebox_tpu_torch.train import create_train_state, make_train_step
from torch_parallel_workers import global_batches, tiny_cfg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL and the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_one_rank_nccl_step_equals_the_bare_step(cuda, tmp_path):
    """The sharded step over a one-rank NCCL group equals the bare step bit
    for bit (same state, batch and draws): parameters, momentum, metrics."""
    cfg = tiny_cfg(batch=4)
    batch = {k: v.to(cuda) for k, v in global_batches(cfg, 1)[0].items()}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        runs = []
        for sharded in (False, True):
            model = DenseBox(cfg.model, device=cuda)
            state = create_train_state(model, cfg, device=cuda)
            if sharded:
                step, place_state, place_batch = make_sharded_train_step(
                    model, cfg, make_mesh(), state, device=cuda)
                state, m = step(place_state(state), place_batch(batch))
            else:
                state, m = make_train_step(model, cfg, device=cuda)(
                    state, batch)
            runs.append((model.state_dict(), state.momentum, m))
    finally:
        dist.destroy_process_group()
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    (a, ma, xa), (b, mb, xb) = runs
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(ma[k], mb[k]), k
    for k in xa:
        assert torch.equal(xa[k], xb[k]), k
