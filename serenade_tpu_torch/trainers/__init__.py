from serenade_tpu_torch.trainers.ssc import SSCTrainer  # noqa: F401
from serenade_tpu_torch.trainers.train_step import (  # noqa: F401
    Optimizer,
    TrainState,
    build_optimizer,
    build_train_step,
    create_train_state,
)
