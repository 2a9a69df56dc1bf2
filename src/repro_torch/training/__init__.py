from repro_torch.training.optimizer import (OptConfig, adamw_init,
                                            adamw_update, lr_at)
from repro_torch.training.train_loop import TrainState, make_train_step
