from .loop import Trainer, init_train_state, make_train_step

__all__ = ["Trainer", "init_train_state", "make_train_step"]
