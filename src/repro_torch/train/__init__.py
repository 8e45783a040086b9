"""Training and serving steps and the fault-tolerant loop (torch
counterpart of ``src/repro/train/``)."""
from .loop import TrainLoop
from .steps import (build_decode_step, build_prefill, build_train_step,
                    cross_entropy_loss)

__all__ = ["build_train_step", "build_prefill", "build_decode_step",
           "cross_entropy_loss", "TrainLoop"]
