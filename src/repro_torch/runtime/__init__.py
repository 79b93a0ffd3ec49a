from .trainer import TrainConfig, Trainer, TrainState, init_state, make_train_step

__all__ = ["TrainConfig", "TrainState", "Trainer", "init_state", "make_train_step"]
