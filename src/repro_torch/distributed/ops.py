"""Tensor ops of the LM stack whose operands may be DTensors.

On plain tensors each is the plain torch op.  On DTensors each computes
on the ranks' shards where torch's own DTensor rules fail (torch 2.11)
or would copy a sharded table whole onto every rank.  The models and
the train step call these and import nothing of ``torch.distributed``;
this module alone knows DTensor's placements.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["add_bias", "cumsum", "einsum", "from_shards", "gather_rows",
           "index_add_rows", "index_copy_", "is_distributed", "lookup",
           "merge_dims", "repeat_heads", "replicated", "roll", "shard_span",
           "split_dim", "target_logits", "tied_logits"]


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


def shard_span(n: int, mesh, placements, dim: int = 0):
    """``(offset, size)`` of this rank's shard of tensor dimension
    ``dim`` (of global size ``n``) under ``placements``, by
    ``torch.chunk``'s rule (shards of ``ceil(size / k)``, nested in mesh
    order), in plain integers: what ``compute_local_shape_and_global_
    offset`` gives, which makes tensors (and so fails under
    ``FakeTensorMode``, as the dry run traces)."""
    coord = mesh.get_coordinate()
    size, off = n, 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(i))
            start = min(chunk * coord[i], size)
            size = max(min(chunk, size - start), 0)
            off += start
    return off, size


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


def _reshard(x: DTensor, axes, dim: int, build, again: bool = True
             ) -> DTensor:
    """``build(x)`` with ``x`` first gathered over the mesh ``axes``, then
    (``again``) sharded over them again on ``dim`` of the result (by
    ``torch.chunk``'s rule: unevenly where they do not divide it)."""
    mesh = x.device_mesh
    whole = [Replicate() if i in axes else p
             for i, p in enumerate(x.placements)]
    y = build(x.redistribute(mesh, whole))
    if not again:
        return y
    return y.redistribute(mesh, [Shard(dim) if i in axes else p
                                 for i, p in enumerate(y.placements)])


def split_dim(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x.unflatten(dim, sizes)`` (heads out of a fused projection).  On
    a DTensor whose ``dim`` is sharded over mesh axes that do not divide
    ``sizes[0]`` (28 heads of a ``28 * 128`` projection over 16 ranks),
    the dimension is gathered over those axes and split: DTensor's view
    rule refuses to split an unevenly sharded dimension.  The first new
    dimension is then sharded over them again, unevenly, as GSPMD pads
    it, unless it is smaller than their ranks (4 KV heads over 16: it
    stays whole)."""
    if isinstance(x, DTensor):
        dim = dim % x.ndim
        axes = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
        k = math.prod(x.device_mesh.size(i) for i in axes)
        if axes and sizes[0] % k:
            return _reshard(x, axes, dim, lambda t: t.unflatten(dim, sizes),
                            again=sizes[0] >= k)
    return x.unflatten(dim, sizes)


def repeat_heads(k: torch.Tensor, groups: int,
                 like: torch.Tensor = None) -> torch.Tensor:
    """``jnp.repeat(k, groups, axis=2)``: [B, S, KV, D] -> [B, S, KV *
    groups, D], query head h reading kv head ``h // groups``.  On a
    DTensor, where ``like`` (the queries, [B, S, H, D]) shards its heads,
    ``k`` is gathered over those mesh axes (where it shards its KV heads)
    and each rank makes only its share of the repeated heads (sharded as
    ``like``'s, by ``torch.chunk``'s rule): no rank holds all of them."""
    b, s, kv, d = k.shape
    if isinstance(k, DTensor) and isinstance(like, DTensor):
        axes = [i for i, p in enumerate(like.placements) if p.is_shard(2)]
    else:
        axes = []
    if not axes:
        return merge_dims(k[:, :, :, None].expand(b, s, kv, groups, d), 2)
    mesh = k.device_mesh
    whole = k.redistribute(mesh, [Replicate() if i in axes else p
                                  for i, p in enumerate(k.placements)])
    out = [Shard(2) if i in axes else p
           for i, p in enumerate(whole.placements)]
    lo, n = shard_span(kv * groups, mesh, out, dim=2)
    local = whole.to_local(grad_placements=[
        Partial() if i in axes else p
        for i, p in enumerate(whole.placements)])
    idx = torch.arange(lo, lo + n, device=local.device) // groups
    return from_shards(local.index_select(2, idx), mesh, out,
                       (b, s, kv * groups, d))


def merge_dims(x: torch.Tensor, dim: int, n: int = 2) -> torch.Tensor:
    """``x.flatten(dim, dim + n - 1)`` (heads back into one dimension).
    On a DTensor with one of those dimensions sharded unevenly, or any
    but the first sharded, they are gathered over those mesh axes,
    flattened, and the result sharded over them again on ``dim`` (evenly
    where they divide it): DTensor's view rule refuses those flattens."""
    if isinstance(x, DTensor):
        dim = dim % x.ndim
        mesh = x.device_mesh
        axes = [i for i, p in enumerate(x.placements)
                if p.is_shard() and dim <= p.dim < dim + n]
        if any(x.placements[i].dim != dim
               or x.shape[dim] % mesh.size(i) for i in axes):
            return _reshard(x, axes, dim,
                            lambda t: t.flatten(dim, dim + n - 1))
    return x.flatten(dim, dim + n - 1)


def index_copy_(t: torch.Tensor, dim: int, index: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``t.index_copy_(dim, index, src)`` for one position (``index`` a
    1-element tensor, read on the device).  On a DTensor each rank
    writes into its own shard, ``src`` placed as ``t`` on the other
    dimensions; where ``t`` is sharded along ``dim`` (a long-context
    cache's sequence over ``data``) a rank writes the position if it
    falls in its shard and rewrites its old row otherwise.  DTensor has
    no rule for ``index_copy_`` (torch 2.11), or takes a shard of ``dim``
    for the whole of it (2.13)."""
    if not isinstance(t, DTensor):
        return t.index_copy_(dim, index, src)
    mesh = t.device_mesh
    lo, n = shard_span(t.shape[dim], mesh, t.placements, dim)
    if n == 0:
        return t
    want = [Replicate() if p.is_shard(dim) else p for p in t.placements]
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, _replicate_all(mesh),
                                 run_check=False)
    src = src.redistribute(mesh, want).to_local()
    if isinstance(index, DTensor):
        index = index.redistribute(mesh, _replicate_all(mesh)).to_local()
    local = t.to_local()
    if n == t.shape[dim]:
        local.index_copy_(dim, index, src)
        return t
    rel = index - lo
    inside = (rel >= 0) & (rel < n)
    rel = rel.clamp(0, n - 1)
    local.index_copy_(dim, rel, torch.where(
        inside, src, local.index_select(dim, rel)))
    return t


def add_bias(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x + b``, ``b`` a bias of ``x``'s last dimension.  On a DTensor
    ``x`` holding partial sums (a projection whose contraction is
    sharded), they are reduced first: onto ``b``'s shards of the last
    dimension where ``b`` is sharded, else whole.  torch 2.11's DTensor
    would move ``b`` to a partial placement instead, which it cannot do
    from a shard."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        bp = (b.placements if isinstance(b, DTensor)
              else _replicate_all(x.device_mesh))
        x = x.redistribute(x.device_mesh, [
            (Shard(x.ndim - 1) if q.is_shard(0) else Replicate())
            if p.is_partial() else p for p, q in zip(x.placements, bp)])
    return x + b


def tied_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``torch.einsum("bsd,vd->bsv", x, table)``: the logits of the tied
    embedding table [V, D].  On DTensors, where the table's vocabulary is
    sharded on no mesh axis (a vocabulary that the axes do not divide:
    the rules shard its D instead), the table is first placed explicitly
    as ``x``'s D is (sharded where ``x``'s is, else whole), so that the
    gradient comes back through that redistribute in the table's own
    placements, those of :func:`lookup`'s gradient: torch 2.11 cannot
    add the two otherwise (it would move a shard to a partial sum)."""
    if isinstance(table, DTensor) and isinstance(x, DTensor) and \
            not any(p.is_shard(0) for p in table.placements):
        d = x.ndim - 1
        table = table.redistribute(table.device_mesh, [
            Shard(1) if px.is_shard(d) else Replicate()
            for px in x.placements])
    return torch.einsum("bsd,vd->bsv", x, table)


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``.  On a DTensor, taken on each rank's
    shard with ``dim`` whole (gathered over the mesh axes that shard it,
    partial sums reduced): torch 2.11's DTensor has no rule for the
    ``flip`` of cumsum's backward."""
    if not isinstance(x, DTensor):
        return torch.cumsum(x, dim)
    dim %= x.ndim
    mesh = x.device_mesh
    placements = [Replicate() if p.is_shard(dim) or p.is_partial() else p
                  for p in x.placements]
    x = x.redistribute(mesh, placements)
    return from_shards(torch.cumsum(x.to_local(), dim), mesh, placements,
                       x.shape)


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
        ids = ids - shard_span(table.shape[0], mesh, table.placements)[0]
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
