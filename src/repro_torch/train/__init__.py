from .loop import (Trainer, init_train_state, make_train_step, shard_batch,
                   shard_train_state, train_state_shapes)

__all__ = ["Trainer", "init_train_state", "make_train_step", "shard_batch",
           "shard_train_state", "train_state_shapes"]
