"""Rank program for ``tests/test_torch_dryrun.py``: the layout helpers of
``repro_torch.distributed.ops`` that the dry run's uneven head counts
need (``split_dim``, ``merge_dims``, ``repeat_heads``, ``shard_span``),
on real DTensors of 4 gloo ranks in a ``(2, 2)`` mesh, against the plain
ops on the whole tensors: values and gradients equal.

    python tests/torch_dist_ops_job.py STORE_DIR

exits 0 when every rank's checks pass."""
import sys

import torch


def job(rank):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import ops
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.distributed.sharding import NamedSharding, P
    mesh = make_host_mesh(model=2)
    dm = mesh.device_mesh
    gen = torch.Generator().manual_seed(0)     # the same on every rank

    def dt(t, spec):
        return distribute(t, NamedSharding(mesh, P(*spec)))

    def check(a, b, what):
        a = a.full_tensor() if isinstance(a, DTensor) else a
        assert torch.equal(a, b), (rank, what, (a - b).abs().max())

    # 5 heads of 4 in a 20-wide projection, the 20 split over 'model'
    x = torch.randn(4, 3, 20, generator=gen)
    xd = dt(x, ("data", None, "model")).requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    heads = ops.split_dim(xd, 2, (5, 4))
    assert heads.placements[1] == Shard(2), heads.placements
    check(heads, xp.unflatten(2, (5, 4)), "split_dim")
    back = ops.merge_dims(heads, 2)
    assert back.placements == xd.placements, back.placements
    check(back, xp, "merge_dims")
    # kv heads repeated 3x for 3 * kv query heads sharded over 'model':
    # 2 kv heads sharded there too, 1 kv head whole
    for kv in (2, 1):
        k = torch.randn(4, 3, kv, 4, generator=gen)
        kd = dt(k, ("data", None, "model" if kv % 2 == 0 else None, None)
                ).requires_grad_(True)
        q = dt(torch.zeros(4, 3, 3 * kv, 4), ("data", None, "model", None))
        kp = k.clone().requires_grad_(True)
        rep = ops.repeat_heads(kd, 3, like=q)
        want = kp.repeat_interleave(3, dim=2)
        check(rep, want, f"repeat_heads kv={kv}")
        w = torch.randn(4, 3, 3 * kv, 4, generator=gen)
        (rep * dt(w, ("data", None, "model", None))).sum().backward()
        (want * w).sum().backward()
        check(kd.grad, kp.grad, f"repeat_heads grad kv={kv}")
    (heads * dt(torch.ones(4, 3, 5, 4), ("data", None, None, None))
     ).sum().backward()
    xp.unflatten(2, (5, 4)).sum().backward()
    check(xd.grad, xp.grad, "split_dim grad")
    # add_bias on partial sums (a projection whose contraction is sharded)
    a, w = torch.randn(4, 6, generator=gen), torch.randn(6, 8, generator=gen)
    bias = torch.randn(8, generator=gen)
    part = dt(a, ("data", "model")) @ dt(w, ("model", None))
    assert any(p.is_partial() for p in part.placements), part.placements
    check(ops.add_bias(part, dt(bias, ("model",))),
          part.full_tensor() + bias, "add_bias")
    # index_copy_ of one position into a cache sharded along it (and not)
    for spec in ((None, "data", "model"), ("data", None, "model")):
        cache = torch.randn(4, 6, 8, generator=gen)
        row = torch.randn(4, 1, 8, generator=gen)
        cd = dt(cache.clone(), spec)
        for pos in (0, 3, 5):
            idx = torch.tensor([pos])
            ops.index_copy_(cd, 1, dt(idx, (None,)),
                            dt(row, (spec[0], None, "model")))
            cache.index_copy_(1, idx, row)
            check(cd, cache, f"index_copy_ {spec} {pos}")
    # a tied table whose vocabulary (5) the axes do not divide: its D is
    # sharded instead; the lookup's and the logits' gradients add up
    table = torch.randn(5, 8, generator=gen)
    toks = torch.tensor([[0, 4, 2], [1, 1, 3], [4, 0, 0], [2, 3, 1]])
    h = torch.randn(4, 3, 8, generator=gen)
    td = dt(table, (None, "data")).requires_grad_(True)
    tp = table.clone().requires_grad_(True)
    hd = dt(h, ("data", None, "model"))
    got = ops.tied_logits(hd + ops.lookup(td, dt(toks, ("data", None))), td)
    want = torch.einsum("bsd,vd->bsv", h + tp[toks], tp)
    assert torch.allclose(got.full_tensor(), want, atol=1e-5), rank
    got.sum().backward()
    want.sum().backward()
    assert td.grad.placements == td.placements, td.grad.placements
    assert torch.allclose(td.grad.full_tensor(), tp.grad, atol=1e-5), rank
    # cumsum along a sharded and an unsharded dimension, and its gradient
    for spec in (("data", "model", None), ("data", None, "model")):
        c = torch.randn(4, 6, 2, generator=gen)
        cd = dt(c, spec).requires_grad_(True)
        cp = c.clone().requires_grad_(True)
        got = ops.cumsum(cd, 1)
        check(got, torch.cumsum(cp, 1), f"cumsum {spec}")
        (got * dt(c, spec)).sum().backward()
        (torch.cumsum(cp, 1) * c).sum().backward()
        assert torch.allclose(cd.grad.full_tensor(), cp.grad, atol=1e-6), \
            (rank, spec)
    # shard_span against DTensor's own local shapes, uneven sizes too
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    for n in (1, 3, 5, 8):
        for pl in ([Shard(0), Replicate()], [Replicate(), Shard(0)],
                   [Shard(0), Shard(0)]):
            shape, off = compute_local_shape_and_global_offset(
                (n, 2), dm, pl)
            assert ops.shard_span(n, dm, pl) == (off[0], shape[0]), \
                (rank, n, pl)


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn
    spawn(job, 4, device="cpu", store_dir=sys.argv[1])
    print("RANKS OK")
