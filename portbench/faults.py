"""Faults planted under the timed path, to show that the comparison
catches them: each patches the program's entry that the cell's driver
calls, for as long as the context lasts.

* ``unchanged``: the step returns its state unchanged (training: AdamW
  leaves parameters and moments as they were; prefill: the cache comes
  back as it went in);
* ``half_batch``: half of the batch is left out, the mean taken over the
  rest (prefill: the first half's answers stand for the whole batch);
* ``altered``: an answer altered where it is produced (prefill: the
  first prompt's logits are the second's).

The exchange between chips is not a fault these one-chip cells can
have.  Used by the tests and by ``calibrate.py``; never by ``run.py``.
"""
from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = {"train": ("unchanged", "half_batch"),
          "prefill": ("unchanged", "half_batch", "altered")}


def _train(fault: str):
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import steps as S
    from repro_torch.tree import leaves
    if fault == "unchanged":
        def adamw_update(grads, state, params, lr, **kw):
            return params, state, {"grad_norm": global_norm(leaves(grads))}
        return mock.patch.object(S, "adamw_update", adamw_update)
    if fault == "half_batch":
        orig = S.value_and_grad

        def value_and_grad(params, batch, *a, **kw):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return orig(params, half, *a, **kw)
        return mock.patch.object(S, "value_and_grad", value_and_grad)
    raise ValueError(f"training has no fault {fault!r}")


def _prefill(fault: str):
    import torch
    from repro_torch.models import model as M
    orig = M.prefill

    def prefill(params, batch, cache, cfg, **kw):
        if fault == "unchanged":
            logits, _ = orig(params, batch, cache, cfg, **kw)
            return logits, cache
        if fault == "half_batch":
            tokens = batch["tokens"]
            half = {"tokens": tokens[: tokens.shape[0] // 2]}
            logits, new = orig(params, half, cache, cfg, **kw)
            new = dict(new)
            new["kv_k"] = torch.cat([new["kv_k"]] * 2, dim=1)
            new["kv_v"] = torch.cat([new["kv_v"]] * 2, dim=1)
            return torch.cat([logits] * 2), new
        if fault == "altered":
            logits, new = orig(params, batch, cache, cfg, **kw)
            logits = logits.clone()
            logits[0] = logits[1]
            return logits, new
        raise ValueError(f"prefill has no fault {fault!r}")
    return mock.patch.object(M, "prefill", prefill)


@contextlib.contextmanager
def planted(kind: str, fault: str):
    with {"train": _train, "prefill": _prefill}[kind](fault):
        yield
