"""Training on one device: the loss, AdamW, the train step, checkpoints
and the online trainer with its weight patches (the JAX package's
``training/``), with a pure-Python msgpack codec for the file formats."""
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from repro_torch.training.losses import cross_entropy  # noqa: F401
from repro_torch.training.online import (  # noqa: F401
    OnlineTrainer, OnlineTrainerConfig, WeightPatch)
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig, OptState, adamw_update, init_opt_state, lr_schedule)
from repro_torch.training.train_loop import (  # noqa: F401
    TrainConfig, make_loss_fn, make_train_step, train)
