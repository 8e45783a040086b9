"""Training driver of the LM stack (torch counterpart of
``src/repro/launch/train.py``): the mesh (production or host), the
profile's shardings (``tp`` | ``fsdp``), sharded AdamW, deterministic
structured data, the fault-tolerant loop with async atomic checkpoints
and resume, for any ``--arch``.

On the card:            python -m repro_torch.launch.train --arch olmo_1b \
                            --steps 1000
On N GPUs of one host:  python -m repro_torch.launch.train --arch olmo_1b \
                            --devices N [--profile fsdp]
On the CPU:             python -m repro_torch.launch.train --arch qwen3_4b \
                            --reduced --device cpu [--devices 8] --steps 50

``--devices N`` spawns N ranks (gloo on the CPU, NCCL with one GPU a
rank) and trains on ``make_host_mesh()`` over them; under ``torchrun``
the ranks join the group it describes.  ``--production-mesh`` takes the
16 x 16 mesh (2 x 16 x 16 with ``--multi-pod``) and needs 256 (512)
ranks.  Without ``--devices`` or ``torchrun`` the host mesh is the one
device, and the step runs on plain tensors as it does without a mesh.
Rank 0 alone prints and writes checkpoints.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional, Sequence

import torch


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--profile", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs 256+ ranks)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="spawn N ranks (gloo on the CPU, one GPU each "
                         "on cuda)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--vocab-chunk", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse(argv)
    from .mesh import join_from_env, spawn
    if args.devices:
        spawn(_rank_main, args.devices, (args,), device=args.device)
        return 0
    joined = join_from_env(args.device)
    try:
        return _train(args)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _rank_main(rank: int, args) -> None:
    _train(args)


def _train(args) -> int:
    import torch.distributed as dist

    from ..ckpt import CheckpointManager
    from ..configs import get_config, reduced
    from ..data import SyntheticTextDataset
    from ..distributed import param_shardings, use_mesh
    from ..distributed.sharding import (NamedSharding, batch_spec,
                                        distribute, distribute_tree)
    from ..kernels.runtime import resolve_device
    from ..models import model as M
    from ..optim import adamw_init
    from ..train import TrainLoop, build_train_step
    from .mesh import make_host_mesh, make_production_mesh

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family == "vlm":
        sys.exit("vlm backbone consumes precomputed embeddings; train a "
                 "text arch or extend the data pipeline with a frontend")
    mesh = (make_production_mesh(multi_pod=args.multi_pod)
            if args.production_mesh else make_host_mesh())
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if rank0:
        print(f"mesh: {dict(mesh.shape)}  profile: {args.profile}  "
              f"device: {name}  arch: {args.arch}"
              f"{' (reduced)' if args.reduced else ''}", flush=True)

    params = M.init_params(cfg, 0, device=device)
    on_mesh = mesh.device_mesh is not None
    if on_mesh:
        params = distribute_tree(params, param_shardings(
            params, mesh, profile=args.profile))
        tok_sh = NamedSharding(mesh, batch_spec(mesh, args.global_batch,
                                                profile=args.profile))
    opt = adamw_init(params)
    base = build_train_step(cfg, base_lr=args.lr, warmup_steps=10,
                            total_steps=args.steps,
                            vocab_chunk=args.vocab_chunk)

    def step_fn(p, o, b, s):
        if not on_mesh:
            return base(p, o, b, s)
        with use_mesh(mesh, profile=args.profile):
            return base(p, o, b, s)

    ds = SyntheticTextDataset(cfg.vocab, args.seq, args.global_batch,
                              seed=0, mode="structured")

    def make_batch(step):
        tokens = torch.from_numpy(ds.batch_at(step)).to(device)
        if on_mesh:
            # every rank draws the same batch: each keeps its own shard
            tokens = distribute(tokens, tok_sh, src_data_rank=None)
        return {"tokens": tokens}

    loop = TrainLoop(step_fn, ds, CheckpointManager(args.ckpt_dir, keep=3),
                     checkpoint_every=args.checkpoint_every,
                     install_signal_handlers=True)
    out = loop.run(params, opt, num_steps=args.steps, make_batch=make_batch)
    if rank0:
        for h in out["history"]:
            print(f"step {h['step']:6d}  loss {h['loss']:.4f}  "
                  f"gnorm {h['grad_norm']:.3f}  "
                  f"{h['step_time_s']*1e3:.0f} ms")
        print(f"finished at step {out['step']}"
              f"{' (preempted, checkpointed)' if out['preempted'] else ''}"
              f"; stragglers: {out['straggler_steps']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
