"""Training driver of the LM stack (torch counterpart of
``src/repro/launch/train.py``): deterministic structured data, AdamW
with warm-up and cosine decay, the fault-tolerant loop with async
atomic checkpoints and resume, for any ``--arch``, on one device.

On the card:           python -m repro_torch.launch.train --arch olmo_1b \
                           --steps 1000
On the CPU:            python -m repro_torch.launch.train --arch qwen3_4b \
                           --reduced --device cpu --steps 50

The reference's mesh flags (``--devices``, ``--production-mesh``,
``--multi-pod``, ``--profile fsdp``) shard the step over a device mesh;
the port has no LM mesh yet (ROADMAP P12c), so they raise.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional, Sequence

import torch

_MESH = "the LM mesh is not ported yet (ROADMAP P12c)"


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--profile", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs 256+ devices)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="force N host devices (CPU testing)")
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
    for flag, on in (("--devices", args.devices),
                     ("--production-mesh", args.production_mesh),
                     ("--multi-pod", args.multi_pod),
                     ("--profile fsdp", args.profile == "fsdp")):
        if on:
            raise NotImplementedError(f"{flag}: {_MESH}")

    from ..ckpt import CheckpointManager
    from ..configs import get_config, reduced
    from ..data import SyntheticTextDataset
    from ..kernels.runtime import resolve_device
    from ..models import model as M
    from ..optim import adamw_init
    from ..train import TrainLoop, build_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family == "vlm":
        sys.exit("vlm backbone consumes precomputed embeddings; train a "
                 "text arch or extend the data pipeline with a frontend")
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}  arch: {args.arch}"
          f"{' (reduced)' if args.reduced else ''}")

    params = M.init_params(cfg, 0, device=device)
    opt = adamw_init(params)
    step_fn = build_train_step(cfg, base_lr=args.lr, warmup_steps=10,
                               total_steps=args.steps,
                               vocab_chunk=args.vocab_chunk)
    ds = SyntheticTextDataset(cfg.vocab, args.seq, args.global_batch,
                              seed=0, mode="structured")

    def make_batch(step):
        return {"tokens": torch.from_numpy(ds.batch_at(step)).to(device)}

    loop = TrainLoop(step_fn, ds, CheckpointManager(args.ckpt_dir, keep=3),
                     checkpoint_every=args.checkpoint_every,
                     install_signal_handlers=True)
    out = loop.run(params, opt, num_steps=args.steps, make_batch=make_batch)
    for h in out["history"]:
        print(f"step {h['step']:6d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  {h['step_time_s']*1e3:.0f} ms")
    print(f"finished at step {out['step']}"
          f"{' (preempted, checkpointed)' if out['preempted'] else ''}; "
          f"stragglers: {out['straggler_steps']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
