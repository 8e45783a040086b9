"""End-to-end training driver: train a (reduced) assigned architecture for a
few hundred steps with the full production stack — deterministic data,
AdamW, cosine schedule, fault-tolerant loop with async checkpoints, resume
(the port of ``examples/train_lm.py``).

The same step function scales to the 256/512-rank meshes of the dry run
(``python -m repro_torch.launch.train --devices N``); here the reduced
config trains on one device, so the loss curve is real.  Runs on the CUDA
device unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --arch qwen3_4b --steps 200
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Dict, Optional, Sequence

import torch

from ..ckpt import CheckpointManager
from ..configs import ARCH_IDS, get_config, reduced
from ..data import SyntheticTextDataset, batch_for_shape
from ..kernels.runtime import resolve_device
from ..models import model as M
from ..optim import adamw_init
from ..train import TrainLoop, build_train_step


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Train and print the loss curve; returns the loop's output."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--arch", default="qwen3_4b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config(args.arch), n_layers=args.layers,
                  d_model=args.d_model, vocab=256)
    if cfg.family == "vlm":
        raise SystemExit("vlm backbone needs embedding inputs; use "
                         "repro_torch.launch.serve_lm or a text arch here")
    print(f"arch={args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab}, {cfg.family})")

    params = M.init_params(cfg, 0, device=device)
    opt = adamw_init(params)
    # the step updates params and moments in place and returns them
    step_fn = build_train_step(cfg, base_lr=args.lr, warmup_steps=20,
                               total_steps=args.steps)
    ds = SyntheticTextDataset(cfg.vocab, args.seq, args.batch, seed=0,
                              mode="structured")

    def make_batch(step):
        b = {"tokens": ds.batch_at(step)}
        if cfg.family == "encdec":
            b = batch_for_shape(cfg, args.batch, args.seq, step)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    loop = TrainLoop(step_fn, ds, CheckpointManager(ckpt_dir, keep=2),
                     checkpoint_every=50, install_signal_handlers=True)
    out = loop.run(params, opt, num_steps=args.steps, make_batch=make_batch)
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  {h['step_time_s']*1e3:.0f} ms")
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first - 0.3 else 'flat'}); "
          f"checkpoints in {ckpt_dir}")
    out["ckpt_dir"] = ckpt_dir
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
