"""Train, prefill and decode steps (torch counterpart of
``src/repro/train/steps.py``).

``build_train_step`` returns ``train_step(params, opt_state, batch,
step) -> (params, opt_state, metrics)``: the forward (each layer
rematerialised), the cross entropy (full or vocab-chunked logsumexp),
the gradients by autograd, the LR schedule and AdamW.  The step reads
nothing back to the host: ``metrics`` holds 0-d device tensors
(``loss``, ``lr``, ``grad_norm``), and a batch already on the device
crosses no copy.  It updates ``params`` and ``opt_state`` in place and
returns them (:func:`repro_torch.optim.adamw_update`), as the
reference's callers donate theirs to its jitted step.

On a mesh (under :func:`repro_torch.distributed.use_mesh`) the same
step takes DTensor parameters, moments and batch (``param_shardings``,
``batch_spec``; a plain batch counts as replicated, so it must be the
same on every rank): the forward's sharding hints redistribute
activations, the
gradients come back as DTensors, AdamW's global norm spans the whole
mesh, and ``metrics`` come back replicated, as plain 0-d tensors equal
on every rank.

``build_prefill`` and ``build_decode_step`` return plain functions that
run under ``torch.inference_mode()`` (``torch.no_grad()`` on a mesh);
there is nothing to jit.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..distributed.ops import is_distributed, replicated, roll, \
    target_logits
from ..distributed.shardctx import current_mesh
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw_update, linear_warmup_cosine
from ..spans import span
from ..tree import leaves, paths, unflatten


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_chunk: int = 0) -> torch.Tensor:
    """Mean next-token CE.  logits [B,S,V] f32-upcast internally.

    ``vocab_chunk`` > 0 computes the logsumexp blockwise over the vocab
    (a running max and rescaled sum, block by block, as the reference);
    0 takes it over the whole vocab at once.
    """
    if vocab_chunk and vocab_chunk < logits.shape[-1]:
        v = logits.shape[-1]
        shape = logits.shape[:-1]
        m = torch.full(shape, -torch.inf, dtype=torch.float32,
                       device=logits.device)
        s = torch.zeros(shape, dtype=torch.float32, device=logits.device)
        for c0 in range(0, v, vocab_chunk):
            blk = logits[..., c0:c0 + vocab_chunk].float()
            bm = torch.amax(blk, dim=-1)
            m2 = torch.maximum(m, bm)
            s = s * torch.exp(m - m2) + torch.sum(
                torch.exp(blk - m2[..., None]), dim=-1)
            m = m2
        lse = m + torch.log(s)
    else:
        lse = torch.logsumexp(logits.float(), dim=-1)
    return torch.mean(lse - target_logits(logits, labels))


def _loss_fn(params, batch: Dict, cfg: ModelConfig, vocab_chunk: int = 0,
             remat: bool = True):
    logits = M.forward(params, batch, cfg, remat=remat)
    with span("loss"):
        labels = batch.get("labels")
        if labels is None:
            # next-token objective on the input stream
            labels = roll(batch["tokens"], -1, 1)
        loss = cross_entropy_loss(logits, labels, vocab_chunk)
    aux = {"loss": loss}
    return loss, aux


def _on_device(batch: Dict, device: torch.device) -> Dict:
    """The batch's arrays as tensors on ``device`` (no copy for a tensor
    already there; a DTensor as it is)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v if is_distributed(v) else v.to(device)
    return out


def value_and_grad(params, batch: Dict, cfg: ModelConfig,
                   vocab_chunk: int = 0, remat: bool = True):
    """``jax.value_and_grad(_loss_fn, has_aux=True)``: ``((loss, aux),
    grads)``, the grads a tree like ``params`` (``None`` where a leaf
    takes no part in the loss).  The leaves are recorded on fresh
    aliases, so ``params`` is left as it was."""
    flat = dict(paths(params))
    live = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with torch.enable_grad():
        loss, aux = _loss_fn(unflatten(live), batch, cfg, vocab_chunk,
                             remat)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), unflatten(dict(zip(live, grads)))


def build_train_step(cfg: ModelConfig, base_lr: float = 3e-4,
                     warmup_steps: int = 100, total_steps: int = 10_000,
                     vocab_chunk: int = 0, remat: bool = True) -> Callable:
    """Returns train_step(params, opt_state, batch, step)."""

    def train_step(params, opt_state, batch, step):
        device = leaves(params)[0].device
        (loss, aux), grads = value_and_grad(
            params, _on_device(batch, device), cfg, vocab_chunk, remat)
        with span("schedule"):
            lr = linear_warmup_cosine(step, base_lr, warmup_steps,
                                      total_steps, device=device)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr)
        metrics = {k: replicated(v) for k, v in
                   {"loss": loss, "lr": lr, **om}.items()}
        return params, opt_state, metrics

    return train_step


def _no_autograd():
    """``torch.inference_mode()``; on a mesh ``torch.no_grad()`` (a
    DTensor's views cannot be made in inference mode)."""
    return torch.no_grad() if current_mesh() is not None \
        else torch.inference_mode()


def build_prefill(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch, cache):
        with _no_autograd():
            return M.prefill(params, batch, cache, cfg)
    return prefill_step


def build_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, tokens, cache):
        with _no_autograd():
            return M.decode_step(params, tokens, cache, cfg)
    return decode_step
