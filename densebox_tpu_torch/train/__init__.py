from densebox_tpu_torch.train.loop import (  # noqa: F401
    TrainState,
    create_train_state,
    learning_rate,
    make_train_step,
    sgd_update,
    step_seed,
)
from densebox_tpu_torch.train.checkpoint import (  # noqa: F401
    is_quantized_dir,
    load_for_inference,
    load_quantized,
    make_manager,
    restore_checkpoint,
    save_checkpoint,
    save_quantized,
)
from densebox_tpu_torch.train.trainer import (  # noqa: F401
    FitResult,
    TrainingDiverged,
    fit,
    make_canvas_train_step,
)
