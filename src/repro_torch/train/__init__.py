"""Serving steps of the LM stack (torch counterpart of
``src/repro/train/``; the training step comes later)."""
from .steps import build_decode_step, build_prefill

__all__ = ["build_prefill", "build_decode_step"]
