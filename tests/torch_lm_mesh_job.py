"""Rank programs of the LM mesh tests, run on spawned gloo ranks (no jax,
no ``repro``): ``python tests/torch_lm_mesh_job.py MODE DIR``.

* ``mesh`` (8 ranks, a ``(4, 2)`` ``data`` x ``model`` mesh): for each
  architecture whose weights ``DIR/in/{arch}.npz`` holds (f32, the
  reference's, flattened by path) and its batch ``DIR/in/{arch}_tokens.npy``,
  one train step under ``tp`` (``fsdp`` too for the first), the gathered
  parameters, moments and metrics to ``DIR/out/{arch}_{profile}.npz``;
  the prefill on the mesh to ``DIR/out/{arch}_prefill.npz``; for the
  first architecture the gradients under ``remat`` off, ``full`` and
  ``dots``, a checkpoint saved on the mesh (``DIR/out/mesh_ckpt``), and
  ``restore_resharded`` of it and of the reference's checkpoint
  ``DIR/in/ref_ckpt`` onto a ``(2, 2)`` mesh of ranks 0-3 under both
  profiles.  Every rank's metrics go to ``DIR/out/rank{r}.json``.
* ``pod`` (4 ranks, a ``pod`` x ``data`` mesh of 2 x 2):
  ``cross_pod_grad_reduce`` of a different gradient tree on each rank
  (plain leaves, a DTensor leaf sharded over ``data`` and one sharded
  over ``pod`` and ``data``), twice (error feedback), to
  ``DIR/out/pod{r}.npz``.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

STEP = dict(warmup_steps=1, total_steps=10)


def _flat(tree):
    from repro_torch.tree import paths
    return dict(paths(tree))


def _full(t):
    from torch.distributed.tensor import DTensor
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().numpy().copy()


def _weights(d, arch):
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.tree import unflatten
    with np.load(os.path.join(d, "in", f"{arch}.npz")) as z:
        return params_from_numpy(unflatten(dict(z)), device="cpu")


def _cfg(arch):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def _placements_ok(tree, shardings):
    sh = _flat(shardings)
    return all(tuple(t.placements) == tuple(sh[k].placements)
               for k, t in _flat(tree).items())


def _train(cfg, mesh, weights, tokens, profile):
    """One step on the mesh: (params, opt, metrics, placements ok)."""
    from repro_torch.distributed import param_shardings, use_mesh
    from repro_torch.distributed.sharding import (NamedSharding, batch_spec,
                                                  distribute, distribute_tree)
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    psh = param_shardings(weights, mesh, profile=profile)
    params = distribute_tree(weights, psh)
    opt = adamw_init(params)
    ok = _placements_ok(params, psh) and _placements_ok(opt["m"], psh)
    batch = {"tokens": distribute(tokens, NamedSharding(
        mesh, batch_spec(mesh, tokens.shape[0], profile=profile)))}
    step = build_train_step(cfg, **STEP)
    with use_mesh(mesh, profile=profile):
        params, opt, metrics = step(params, opt, batch, 1)
    ok = ok and _placements_ok(params, psh) and _placements_ok(opt["v"], psh)
    return params, opt, metrics, ok


def _save(path, rank, **trees):
    """Gather every leaf (each rank calls it) and write them on rank 0."""
    out = {}
    for name, tree in trees.items():
        for k, t in _flat(tree).items():
            out[f"{name}:{k}"] = _full(t)
    if rank == 0:
        np.savez(path, **out)


def _mesh_rank(rank, d, archs):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt import CheckpointManager, restore_resharded
    from repro_torch.distributed import (cache_shardings, input_shardings,
                                         param_shardings, use_mesh)
    from repro_torch.distributed.sharding import distribute, distribute_tree
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.train import build_prefill
    from repro_torch.train.steps import value_and_grad

    out = os.path.join(d, "out")
    mesh = make_host_mesh(model=2)
    assert mesh.shape == {"data": 4, "model": 2}, mesh
    report = {"placements": {}, "metrics": {}}
    for i, arch in enumerate(archs):
        cfg = _cfg(arch)
        tokens = torch.from_numpy(np.load(os.path.join(d, "in",
                                                       f"{arch}_tokens.npy")))
        for profile in (("tp", "fsdp") if i == 0 else ("tp",)):
            params, opt, metrics, ok = _train(cfg, mesh, _weights(d, arch),
                                              tokens, profile)
            assert not any(isinstance(v, DTensor) for v in metrics.values())
            report["placements"][f"{arch}_{profile}"] = ok
            report["metrics"][f"{arch}_{profile}"] = {
                k: float(v) for k, v in metrics.items()}
            _save(os.path.join(out, f"{arch}_{profile}.npz"), rank,
                  params=params, m=opt["m"], v=opt["v"])
            if i == 0 and profile == "tp":
                mgr = CheckpointManager(os.path.join(out, "mesh_ckpt"))
                mgr.save(1, params, opt, {"mesh": "4x2"})
                report["latest_step"] = mgr.latest_step()
        # prefill on the mesh
        weights = _weights(d, arch)
        params = distribute_tree(weights, param_shardings(weights, mesh))
        B = tokens.shape[0]
        cache = M.init_cache(cfg, B, 80, device="cpu")
        cache = distribute_tree(cache, cache_shardings(mesh, cache, B))
        batch = {"tokens": distribute(tokens,
                                      input_shardings(mesh, B)["tokens"])}
        with use_mesh(mesh):
            logits, cache2 = build_prefill(cfg)(params, batch, cache)
        _save(os.path.join(out, f"{arch}_prefill.npz"), rank,
              logits={"logits": logits}, cache=cache2)
    # remat off, full and dots on the mesh: the same loss and gradients
    arch = archs[0]
    cfg = _cfg(arch)
    tokens = torch.from_numpy(np.load(os.path.join(d, "in",
                                                   f"{arch}_tokens.npy")))
    weights = _weights(d, arch)
    params = distribute_tree(weights, param_shardings(weights, mesh))
    batch = {"tokens": distribute(tokens, input_shardings(
        mesh, tokens.shape[0])["tokens"])}
    grads = {}
    for name, c, remat in (("none", cfg, False), ("full", cfg, True),
                           ("dots", dataclasses.replace(
                               cfg, remat_policy="dots"), True)):
        with use_mesh(mesh):
            (loss, _), g = value_and_grad(params, batch, c, remat=remat)
        grads[name] = (float(loss.full_tensor()),
                       {k: _full(t) for k, t in _flat(g).items()})
    report["remat"] = {
        name: {"loss_equal": grads[name][0] == grads["none"][0],
               "grads_max_diff": max(
                   float(np.abs(grads[name][1][k] - v).max())
                   for k, v in grads["none"][1].items())}
        for name in ("full", "dots")}
    # restore_resharded onto a (2, 2) mesh of ranks 0-3
    small = make_host_mesh(2, 2)
    if small.device_mesh.get_coordinate() is not None:
        skeleton = M.abstract_params(cfg)
        for src, step in (("mesh_ckpt", 1), ("ref_ckpt", 3)):
            root = os.path.join(out if src == "mesh_ckpt" else
                                os.path.join(d, "in"), src)
            for profile in ("tp", "fsdp"):
                sh = param_shardings(skeleton, small, profile=profile)
                got = restore_resharded(CheckpointManager(root), skeleton,
                                        sh, step=step)
                report["placements"][f"restore_{src}_{profile}"] = \
                    _placements_ok(got, sh)
                local = {k: list(t.to_local().shape)
                         for k, t in _flat(got).items()}
                report.setdefault("restore_local_shapes", {})[
                    f"{src}_{profile}"] = local
                _save(os.path.join(out, f"restore_{src}_{profile}.npz"),
                      rank, params=got)
    dist.barrier()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def _pod_rank(rank, d):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import cross_pod_grad_reduce
    from repro_torch.launch import make_mesh
    mesh = make_mesh((2, 2), ("pod", "data"))
    rng = np.random.default_rng(100 + rank)
    grads = {"a": torch.from_numpy(rng.standard_normal((64, 33)).astype(
                 np.float32) * (1 + rank)),
             "b": {"c": torch.from_numpy(np.linspace(
                 -1 - rank, 2, 101, dtype=np.float32))},
             "d": torch.from_numpy(rng.standard_normal(17).astype(
                 np.float32)).to(torch.bfloat16)}
    errors = {"a": torch.zeros(64, 33), "b": {"c": torch.zeros(101)},
              "d": torch.zeros(17)}
    # DTensor leaves: "e" replicated over pods (each pod its own value)
    # and sharded over data, "f" sharded over pods and data (fsdp)
    for key, shape, placements in (
            ("e", (20,), [Replicate(), Shard(0)]),
            ("f", (8, 3), [Shard(0), Shard(0)])):
        local = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * (1 + rank))
        grads[key] = DTensor.from_local(local, mesh.device_mesh, placements,
                                        run_check=False)
        errors[key] = DTensor.from_local(torch.zeros(shape),
                                         mesh.device_mesh, placements,
                                         run_check=False)
    out = {}
    for k, g in _flat(grads).items():
        out[f"grad:{k}"] = (g.to_local() if isinstance(g, DTensor)
                            else g).float().numpy().copy()
    for rnd in (0, 1):
        red, errors = cross_pod_grad_reduce(grads, mesh, errors)
        for k, t in _flat(red).items():
            assert isinstance(t, DTensor) == (k in ("e", "f")), k
            if isinstance(t, DTensor):
                assert t.placements == grads[k].placements, k
            loc = t.to_local() if isinstance(t, DTensor) else t
            assert loc.dtype == (torch.bfloat16 if k == "d"
                                 else torch.float32), (k, loc.dtype)
            out[f"red{rnd}:{k}"] = loc.float().numpy().copy()
        for k, t in _flat(errors).items():
            loc = t.to_local() if isinstance(t, DTensor) else t
            out[f"err{rnd}:{k}"] = loc.numpy().copy()
    np.savez(os.path.join(d, "out", f"pod{rank}.npz"), **out)


def main(mode, d, archs=()):
    from repro_torch.launch import spawn
    os.makedirs(os.path.join(d, "out"), exist_ok=True)
    if mode == "mesh":
        spawn(_mesh_rank, 8, (d, list(archs)), device="cpu", store_dir=d)
    elif mode == "pod":
        spawn(_pod_rank, 4, (d,), device="cpu", store_dir=d)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3:])
