"""Tensor ops of the LM stack whose operands may be DTensors.

On plain tensors each is the plain torch op.  On DTensors each computes
on the ranks' shards where torch's own DTensor rules fail (torch 2.11)
or would copy a sharded table whole onto every rank.  The models and
the train step call these and import nothing of ``torch.distributed``;
this module alone knows DTensor's placements.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["einsum", "from_shards", "gather_rows", "index_add_rows",
           "is_distributed", "lookup", "replicated", "roll",
           "target_logits"]


def is_distributed(t) -> bool:
    return isinstance(t, DTensor)


def replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value as a plain tensor (the same on every
    rank); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def from_shards(local: torch.Tensor, mesh, placements,
                shape) -> DTensor:
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local`` (made contiguous) under ``placements``."""
    shape = torch.Size(shape)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _replicate_all(mesh):
    return (Replicate(),) * mesh.ndim


def einsum(eq: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, y)`` of two operands.  On DTensors sharded
    only over labels that reach the output (none summed over), the
    product is taken on each rank's shards: on each mesh axis both
    operands are placed on the label ``x`` shards there (else the one
    ``y`` shards; an operand without that label replicated), and the
    local products form the output, sharded on that label (an operand
    replicated where the output is sharded takes a partial gradient
    there).  DTensor's own rule flattens the shared labels into one
    ``bmm`` batch, which torch 2.11 refuses once two of them are sharded
    (batch over ``data``, heads over ``model``).  Other operands take
    ``torch.einsum``."""
    if not (isinstance(x, DTensor) and isinstance(y, DTensor)):
        return torch.einsum(eq, x, y)
    ins, out = eq.split("->")
    lx, ly = ins.split(",")
    x_to, y_to, o_to = [], [], []
    for px, py in zip(x.placements, y.placements):
        label = (lx[px.dim] if px.is_shard() else
                 ly[py.dim] if py.is_shard() else None)
        if label is None:
            x_to.append(Replicate())
            y_to.append(Replicate())
            o_to.append(Replicate())
            continue
        if label not in out:
            return torch.einsum(eq, x, y)
        x_to.append(Shard(lx.index(label)) if label in lx else Replicate())
        y_to.append(Shard(ly.index(label)) if label in ly else Replicate())
        o_to.append(Shard(out.index(label)))
    mesh = x.device_mesh
    x, y = x.redistribute(mesh, x_to), y.redistribute(mesh, y_to)
    sizes = dict(zip(lx, x.shape))
    sizes.update(zip(ly, y.shape))
    shape = torch.Size(sizes[c] for c in out)

    def local(t, to):
        return t.to_local(grad_placements=[
            Partial() if p.is_replicate() and o.is_shard() else p
            for p, o in zip(to, o_to)])
    return from_shards(torch.einsum(eq, local(x, x_to), local(y, y_to)),
                       mesh, o_to, shape)


def roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(x, shift, dim)`` as two slices and a concatenation
    (the same values): DTensor (torch 2.11) has no sharding rule for
    ``aten.roll``."""
    n = x.shape[dim]
    s = shift % n
    if s == 0:
        return x
    return torch.cat([x.narrow(dim, n - s, s), x.narrow(dim, 0, n - s)],
                     dim=dim)


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``: the rows of ``table`` [V, D] at
    ``tokens``.  On a mesh each rank looks its tokens up in its own shard
    of the table, and no rank holds more of the table than its shard.
    Over a mesh axis that shards the table the tokens are gathered (B·S
    integers).  Where that axis shards the vocabulary, a token outside
    the rank's rows gives a zero row, and the output is a partial sum
    over the axis (exact: one term is not zero), which the caller's
    ``constrain`` reduces (B·S·D values).  Where it shards D, the output
    is sharded over D there.  On the other axes the output is placed as
    the tokens are.  DTensor's own rules (torch 2.11) fail on a
    vocab-sharded table: ``F.embedding``'s masked partial once it
    redistributes the tokens, indexing's ``index_put`` backward."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    rows = (tokens.placements if isinstance(tokens, DTensor)
            else _replicate_all(mesh))
    gather, out, grad = [], [], []
    for pt, pk in zip(table.placements, rows):
        if pt.is_shard():
            gather.append(Replicate())
            out.append(Partial() if pt.dim == 0 else Shard(tokens.ndim))
            grad.append(pt)
        else:
            gather.append(pk)
            out.append(pk)
            # this rank's tokens are a part of the ones on the axis
            grad.append(Partial() if pk.is_shard() else Replicate())
    ids = (tokens.redistribute(mesh, gather).to_local()
           if isinstance(tokens, DTensor) else tokens)
    local = table.to_local(grad_placements=grad)
    if any(p.is_shard(0) for p in table.placements):
        _, offset = compute_local_shape_and_global_offset(
            table.shape, mesh, table.placements)
        ids = ids - offset[0]
        inside = (ids >= 0) & (ids < local.shape[0])
        got = F.embedding(torch.where(inside, ids, 0), local)
        got = torch.where(inside[..., None], got, 0.0)
    else:
        got = F.embedding(ids, local)
    return from_shards(got, mesh, out,
                       tuple(tokens.shape) + (table.shape[1],))


def index_add_rows(rows: int, index: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """``zeros((rows, D)).index_add(0, index, src)``.  On a mesh every
    rank adds all the tokens (gathered) into its own copy of the buffer
    (its shard of D): DTensor's ``index_add`` rule (torch 2.11) mis-sizes
    a token-sharded source, and an in-place add from a DTensor into a
    plain buffer is refused."""
    if not isinstance(src, DTensor):
        buf = torch.zeros((rows, src.shape[1]), dtype=src.dtype,
                          device=src.device)
        return buf.index_add_(0, index, src)
    mesh = src.device_mesh
    keep = tuple(p if p.is_shard() and p.dim == 1 else Replicate()
                 for p in src.placements)
    local = src.redistribute(mesh, keep).to_local()
    if isinstance(index, DTensor):
        index = index.redistribute(mesh, _replicate_all(mesh)).to_local()
    buf = torch.zeros((rows, local.shape[1]), dtype=src.dtype,
                      device=local.device)
    return from_shards(buf.index_add_(0, index, local), mesh, keep,
                       (rows, src.shape[1]))


def gather_rows(out: torch.Tensor, expert: torch.Tensor,
                slot: torch.Tensor) -> torch.Tensor:
    """``out[expert, slot]`` ([E, C, D] -> [T*K, D]).  On a mesh each rank
    gathers its own tokens' rows from the whole buffer (its shard of D),
    so the buffer's gradient is a partial sum over the ranks that hold
    other tokens: DTensor's ``index_put`` rule (the backward; torch
    2.11) fails on these placements."""
    if not isinstance(out, DTensor):
        return out[expert, slot]
    mesh = out.device_mesh
    n = expert.shape[0]
    rows = (expert.placements if isinstance(expert, DTensor)
            else _replicate_all(mesh))
    rows = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                 for p in rows)
    cols = tuple(p if p.is_shard() and p.dim == 2 and not r.is_shard()
                 else Replicate() for p, r in zip(out.placements, rows))
    table = out.redistribute(mesh, cols).to_local(grad_placements=[
        Partial() if r.is_shard() else c for r, c in zip(rows, cols)])
    expert, slot = (t.redistribute(mesh, rows).to_local()
                    if isinstance(t, DTensor) else t
                    for t in (expert, slot))
    placements = tuple(r if r.is_shard() else
                       Shard(1) if c.is_shard() else Replicate()
                       for r, c in zip(rows, cols))
    return from_shards(table[expert, slot], mesh, placements,
                       (n, out.shape[2]))


def target_logits(logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` in f32.  On a mesh as a masked sum over the
    vocab (one term is not zero, so the sum is exact): DTensor's
    ``gather`` rule on a vocab-sharded tensor leaves a partial value
    that it then fails to reduce."""
    if isinstance(logits, DTensor):
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        hit = vocab == labels[..., None].long()
        return torch.where(hit, logits, 0.0).sum(dim=-1).float()
    return torch.gather(logits, -1, labels[..., None].long())[..., 0].float()
