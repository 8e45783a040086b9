"""Optimizer substrate (torch counterpart of ``src/repro/optim/``):
AdamW with f32 moments, global-norm clipping and the LR schedules."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup_cosine"]
