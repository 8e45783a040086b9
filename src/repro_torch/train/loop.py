"""Fault-tolerant training loop (torch counterpart of
``src/repro/train/loop.py``, line for line).

  * step-atomic checkpoints every N steps via the async CheckpointManager;
  * auto-resume: on start, the loop restores the latest checkpoint and the
    deterministic data pipeline resumes at exactly the right step (O(1)
    skip — no replay);
  * preemption hook: SIGTERM/SIGINT triggers a synchronous final checkpoint
    before exit (the SLURM/GKE eviction pattern);
  * straggler mitigation: per-step wall-time EWMA is tracked and steps
    slower than ``straggler_factor`` x EWMA are counted and surfaced in
    the result.

A step's time ends when its device has finished it (where the reference
calls ``jax.block_until_ready``); the loss is read on the host only at
log and checkpoint steps.

On a mesh every rank runs the loop with the same arguments: the step's
metrics are replicated, the checkpoint manager gathers on every rank and
writes on rank 0, and the resumed step is rank 0's on every rank.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..ckpt import CheckpointManager


def _block_until_ready(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class TrainLoop:
    def __init__(self, train_step: Callable, dataset, ckpt: CheckpointManager,
                 checkpoint_every: int = 50, straggler_factor: float = 3.0,
                 install_signal_handlers: bool = False):
        self.train_step = train_step
        self.dataset = dataset
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.straggler_factor = straggler_factor
        self._preempted = False
        self.step_time_ewma: Optional[float] = None
        self.straggler_steps = 0
        if install_signal_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, self._on_preempt)

    def _on_preempt(self, signum, frame):  # pragma: no cover - signal path
        self._preempted = True

    # ------------------------------------------------------------------
    def run(self, params: Any, opt_state: Any, num_steps: int,
            start_step: int = 0, make_batch: Optional[Callable] = None,
            log_every: int = 10) -> Dict[str, Any]:
        """Run (or resume) training.  Returns final state + history."""
        resume = self.ckpt.latest_step()
        if resume is not None and resume > start_step:
            params, opt_state, manifest = self.ckpt.restore(
                params, opt_state, resume)
            start_step = manifest["step"]
        history = []
        step = start_step
        while step < num_steps and not self._preempted:
            t0 = time.monotonic()
            batch = (make_batch(step) if make_batch is not None
                     else {"tokens": self.dataset.batch_at(step)})
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch, step)
            _block_until_ready(metrics["loss"])
            dt = time.monotonic() - t0
            if self.step_time_ewma is None:
                self.step_time_ewma = dt
            else:
                if dt > self.straggler_factor * self.step_time_ewma:
                    self.straggler_steps += 1
                self.step_time_ewma = 0.9 * self.step_time_ewma + 0.1 * dt
            step += 1
            if step % log_every == 0 or step == num_steps:
                history.append({"step": step,
                                "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "step_time_s": dt})
            if step % self.checkpoint_every == 0:
                self.ckpt.async_save(step, params, opt_state,
                                     {"loss": float(metrics["loss"])})
        # final (or preemption) checkpoint — synchronous
        self.ckpt.save(step, params, opt_state, {"final": True,
                                                 "preempted": self._preempted})
        return {"params": params, "opt_state": opt_state, "step": step,
                "history": history, "preempted": self._preempted,
                "straggler_steps": self.straggler_steps}
