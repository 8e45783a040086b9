"""Serving entry point of the LM stack: batched prefill + greedy decode
with KV/SSM caches (the port of ``examples/serve_lm.py``).

Runs the serving path (prefill fills the cache, decode steps extend it)
on a reduced config, the sliding-window ring buffer (mixtral) and the
O(1) SSM state (falcon-mamba) included, on the CUDA device unless
``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch mixtral_8x7b
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, reduced
from ..kernels.runtime import resolve_device
from ..models import model as M
from ..train.steps import build_decode_step, build_prefill


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral_8x7b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    if cfg.family == "vlm":
        raise SystemExit("use a text arch for this example")
    device = resolve_device(args.device)
    params = M.init_params(cfg, 0, device=device)

    B, S = args.batch, args.prompt_len
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(device)
    batch = {"tokens": prompt}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(device)

    max_seq = S + args.new_tokens
    cache = M.init_cache(cfg, B, max_seq=max_seq, device=device)
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    print(f"arch={args.arch} family={cfg.family} cache={cache_bytes/1e6:.2f}"
          f" MB (window={cfg.sliding_window or 'full'})")

    prefill = build_prefill(cfg)
    decode = build_decode_step(cfg)

    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
    generated = [toks]
    t0 = time.perf_counter()
    for _ in range(args.new_tokens - 1):
        logits, cache = decode(params, toks, cache)
        toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
        generated.append(toks)
    _sync(device)
    t_decode = time.perf_counter() - t0

    out = torch.cat(generated, dim=1)
    print(f"prefill {S} tokens x{B}: {t_prefill*1e3:.1f} ms; "
          f"decode {args.new_tokens} tokens: "
          f"{t_decode/max(args.new_tokens-1,1)*1e3:.2f} ms/token")
    print("sample continuation (seq 0):", out[0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
