from densebox_tpu_torch.train.loop import (  # noqa: F401
    TrainState,
    create_train_state,
    learning_rate,
    make_train_step,
    sgd_update,
)
from densebox_tpu_torch.train.trainer import make_canvas_train_step  # noqa: F401
