from repro_torch.train.loss import lm_loss
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.train.step import build_eval_step, build_train_step

__all__ = ["lm_loss", "TrainState", "init_train_state", "build_train_step", "build_eval_step"]
