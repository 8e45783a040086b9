"""Prefill and decode steps (``build_prefill``, ``build_decode_step`` of
``src/repro/train/steps.py``).

Each returns a plain function of (params, batch or tokens, cache) that
runs under ``torch.inference_mode()``; there is nothing to jit.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import model as M
from ..models.config import ModelConfig


def build_prefill(cfg: ModelConfig) -> Callable:
    @torch.inference_mode()
    def prefill_step(params, batch, cache):
        return M.prefill(params, batch, cache, cfg)
    return prefill_step


def build_decode_step(cfg: ModelConfig) -> Callable:
    @torch.inference_mode()
    def decode_step(params, tokens, cache):
        return M.decode_step(params, tokens, cache, cfg)
    return decode_step
