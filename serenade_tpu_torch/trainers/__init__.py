from serenade_tpu_torch.trainers.ssc import (  # noqa: F401
    SSCTrainer,
    SSCTrainerNew,
)
from serenade_tpu_torch.trainers.train_step import (  # noqa: F401
    Optimizer,
    TrainState,
    build_optimizer,
    build_train_step,
    create_train_state,
)
from serenade_tpu_torch.trainers.distill import (  # noqa: F401
    build_distill_step,
    distill_trainable_mask,
)
