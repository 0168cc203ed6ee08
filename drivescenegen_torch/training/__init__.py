from drivescenegen_torch.training.trainer import (  # noqa: F401
    TrainState,
    create_optimizer,
    init_train_state,
    make_train_step,
)
