"""Training substrate: AdamW, the cosine schedule, TrainState and the
train-step factory (remat, gradient clipping, one captured program)."""

from .optimizer import (AdamWState, adamw_init, adamw_update,
                        clip_by_global_norm, cosine_schedule)
from .trainer import (TrainState, init_train_state, make_train_step,
                      train_state_sharding)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm", "TrainState", "init_train_state",
           "make_train_step", "train_state_sharding"]
