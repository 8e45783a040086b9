"""AdamW with decoupled weight decay and f32 moments (torch counterpart
of ``src/repro/optim/adamw.py``).

Trees are nested dicts of tensors.  Leaves are visited in the
reference's order, ``jax.tree.leaves``' (keys sorted at every level),
so the global norm sums its squares in the same order.  The arithmetic
is the reference's, cast for cast: the clip scales in f32 and rounds
back to the gradient's dtype (bf16 rounds twice, as it does there), the
moments and the step are f32, decay applies to leaves with
``ndim >= 2`` (a stacked per-layer norm scale ``[L, d]`` included, as in
the reference), and a leaf with no gradient (``None``) takes zeros, so
its moments still decay and its weight decay still applies.

On a mesh the leaves are DTensors: the global norm's squares sum over
the whole mesh (one all-reduce), and the 0-d ``lr``, ``count`` and bias
corrections meet them as replicated values.

One difference, on purpose: :func:`adamw_update` writes the new
parameters and moments into the caller's tensors in place (under
``torch.no_grad()``) and returns the same dicts; the reference's
callers donate theirs (``launch/train.py:95``).  A caller that keeps
the old values clones them first.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..spans import span
from ..tree import leaves as tree_leaves
from ..tree import tree_map

OptState = Dict[str, Any]


def adamw_init(params: Any) -> OptState:
    """f32 zeros like each leaf (``m``, ``v``; a DTensor leaf's are
    DTensors with its placements) and ``count``, a 0-d int32, all on the
    parameters' device."""
    def f32(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return {"m": tree_map(f32, params), "v": tree_map(f32, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}


def global_norm(flat_g: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """``sqrt`` of the f32 sum of squares, leaf by leaf in order (``None``
    adds nothing)."""
    sq = 0
    for g in flat_g:
        if g is not None:
            sq = sq + torch.sum(torch.square(g.float()))
    return torch.sqrt(sq)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(g.astype(f32) * scale).astype(g.dtype)``, upcast again: what
    the reference's ``upd`` reads of a clipped gradient."""
    g32 = g.float() * scale
    if g.dtype != torch.float32:
        g32 = g32.to(g.dtype).float()
    return g32


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """The gradients scaled to a global norm of at most ``max_norm``
    (each in its own dtype) and the norm before the clip."""
    norm = global_norm(tree_leaves(grads))
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: None if g is None
                    else _scaled(g, scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads: Any, state: OptState, params: Any, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0) -> Tuple[Any, OptState, Dict]:
    """One AdamW step after a global-norm clip.  Updates ``params`` and
    ``state``'s moments in place and returns ``(params, state,
    {"grad_norm": norm})``; ``state["count"]`` is replaced by
    ``count + 1``.  ``lr`` is a float or a 0-d f32 tensor."""
    with span("adamw"):
        flat_p = tree_leaves(params)
        flat_g = tree_leaves(grads)
        if len(flat_g) != len(flat_p):
            raise ValueError(f"{len(flat_g)} gradients for {len(flat_p)} "
                             f"parameters")
        flat_m = tree_leaves(state["m"])
        flat_v = tree_leaves(state["v"])
        gnorm = global_norm(flat_g)
        scale = _clip_scale(gnorm, max_grad_norm)
        count = state["count"] + 1
        c = count.float()
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g32 = (torch.zeros_like(p, dtype=torch.float32)
                   if g is None else _scaled(g, scale))
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_(((1 - b2) * g32).mul_(g32))
            del g32
            step = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            # decoupled weight decay on matrices only (ndim >= 2)
            if p.ndim >= 2:
                step.add_(weight_decay * p.float())
            step.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(step)
            else:
                p.copy_(p.float().sub_(step))
        state["count"] = count
        return params, state, {"grad_norm": gnorm}
