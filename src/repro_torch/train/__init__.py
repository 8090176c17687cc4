"""The LLM zoo's training step (the port of the reference's ``train/``)."""
from .train_loop import TrainCfg, init_state, make_train_step

__all__ = ["TrainCfg", "init_state", "make_train_step"]
