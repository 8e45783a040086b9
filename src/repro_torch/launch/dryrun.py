"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on a
fake process group (torch counterpart of ``src/repro/launch/dryrun.py``,
function for function).

The reference forces 512 placeholder host devices at import and lowers
and compiles each cell with XLA.  Here :func:`run_cell` (or :func:`main`)
starts one fake process group of world 512 (``torch.distributed``'s
``fake`` backend, rank 0), never at import, and refuses to run inside a
real group.  Each cell's parameters, optimizer state, batch and cache are
fake DTensors (``FakeTensorMode``: shapes, dtypes and placements, no
storage) on a production mesh (``make_production_mesh``: ranks 0-255 for
16 x 16, all 512 for 2 x 16 x 16), and rank 0 runs the step once under
:class:`repro_torch.energy.StepTrace`, which counts what that rank runs.

Per cell this harness produces:
  * feasibility proof: the full-depth step runs on the mesh (every
    DTensor rule it needs exists at these sizes);
  * memory proof: rank 0's argument, temporary and output bytes
    (``peak = arg + temp``, as the reference defines it);
  * costs (single-pod): the full-depth trace's own counts.  The layer
    loop is plain Python, so the trace sees every layer (the reference
    diffs L=2 and L=4 because XLA counts a ``lax.scan`` body once).  The
    record's ``per_layer`` and ``cost_base`` come from one more trace at
    L=2 (identical widths and shardings), diffed against the full
    depth; hybrid archs add a trace at L=2 with shared attention every
    block for the shared block;
  * roofline terms and the CamJ-style energy breakdown on the ``H100``
    (the record names it).

The fake tensors live on ``device`` (``cuda`` by default, which needs a
GPU; ``cpu`` when asked).  Results go to ``build/dryrun.json`` under the
repository root (or ``--out``); reruns skip completed cells unless
``--force``.

    python -m repro_torch.launch.dryrun --arch olmo_1b --shape decode_32k \\
        --mesh single --no-costs [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..configs import ARCH_IDS, get_config
from ..distributed.sharding import (NamedSharding, P, cache_shardings,
                                    input_shardings, param_shardings)
from ..distributed.shardctx import use_mesh
from ..energy import (model_flops, roofline_terms, tpu_energy_report,
                      trace_step)
from ..energy.roofline import H100
from ..kernels.runtime import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..tree import paths, unflatten
from .mesh import make_production_mesh
from .shapes import SHAPES, ShapeSpec, cell_skip_reason

WORLD = 512
RESULTS_DIR = Path(__file__).resolve().parents[3] / "build"
COST_KEYS = ("flops_dev", "bytes_dev", "bytes_hlo_dev", "coll_bytes_dev")


# ---------------------------------------------------------------------------
# The fake process group
# ---------------------------------------------------------------------------
def fake_group(world: int = WORLD) -> bool:
    """Join a fake process group of ``world`` ranks as rank 0 (no peer,
    no transport: collectives return at once), unless one is already
    running; a real group refuses the dry run.  True when it started the
    group (the caller then destroys it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is running: the "
                f"dry run traces on a fake group of {world} ranks of its "
                f"own; run it in a process without one")
        if dist.get_world_size() < world:
            raise RuntimeError(f"the fake group has "
                               f"{dist.get_world_size()} ranks, the dry "
                               f"run needs {world}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return True


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors: no allocation)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                device="meta") -> Dict[str, torch.Tensor]:
    """Abstract model inputs for one cell (``meta`` tensors by default).
    [vlm]/[audio] frontends are stubs: precomputed patch/frame
    embeddings feed the backbone."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)
    if shape.kind == "decode":
        tok = (spec((B, 1, cfg.d_model), dt) if cfg.family == "vlm"
               else spec((B, 1), torch.int32))
        return {"tokens": tok}
    batch: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        batch["embeds"] = spec((B, S, cfg.d_model), dt)
        batch["labels"] = spec((B, S), torch.int32)
    else:
        batch["tokens"] = spec((B, S), torch.int32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = spec((B, cfg.encoder_seq, cfg.d_model), dt)
    return batch


def _batch_shardings(mesh, cfg: ModelConfig, batch: Dict[str, Any],
                     global_batch: int, profile: str = "tp"):
    from ..distributed.sharding import batch_spec
    tok_spec = batch_spec(mesh, global_batch, extra_dims=1, profile=profile)
    out = {}
    for k, v in batch.items():
        if k in ("embeds", "audio_embeds") or (k == "tokens" and v.ndim == 3):
            if profile == "fsdp":
                out[k] = NamedSharding(mesh, P(*tok_spec, None))
            else:
                out[k] = input_shardings(mesh, global_batch)["embeds"]
        else:
            spec = list(tok_spec)[:v.ndim]
            spec += [None] * (v.ndim - len(spec))
            out[k] = NamedSharding(mesh, P(*spec))
    return out


def fake_dtensor(shape, dtype, device_mesh, placements, device):
    """A DTensor of global ``shape`` under ``placements`` whose local
    tensor is this rank's shard, made empty on ``device`` (call inside
    ``FakeTensorMode``: no storage)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from ..distributed.ops import from_shards
    with unset_fake_temporarily():
        local, _ = compute_local_shape_and_global_offset(
            torch.Size(shape), device_mesh, placements)
    return from_shards(torch.empty(local, dtype=dtype, device=device),
                       device_mesh, placements, shape)


def _fake_tree(tree, shardings, device):
    sh = dict(paths(shardings))
    return unflatten({k: fake_dtensor(t.shape, t.dtype,
                                      sh[k].mesh.device_mesh,
                                      sh[k].placements, device)
                      for k, t in paths(tree)})


# ---------------------------------------------------------------------------
# Step builders (fake arguments + the step)
# ---------------------------------------------------------------------------
def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, unroll: bool,
               vocab_chunk: int = 0, profile: str = "tp", device="cuda"):
    """Returns ``(fn, args)``: the step and its fake DTensor arguments
    (call inside ``FakeTensorMode``).  ``unroll`` changes nothing in
    torch (the layer loop is Python); it is kept for the reference's
    signature."""
    del unroll
    device = torch.device(device)
    params = M.abstract_params(cfg)
    psh = param_shardings(params, mesh, profile=profile)
    batch = input_specs(cfg, shape)
    bsh = _batch_shardings(mesh, cfg, batch, shape.global_batch,
                           profile=profile)
    fparams = _fake_tree(params, psh, device)
    fbatch = _fake_tree(batch, bsh, device)

    if shape.kind == "train":
        from ..optim import adamw_init, adamw_update
        from ..train.steps import value_and_grad
        opt = adamw_init(fparams)

        def fn(p, o, b):
            with use_mesh(mesh, profile=profile):
                (lval, _), grads = value_and_grad(p, b, cfg, vocab_chunk,
                                                  remat=True)
                newp, newo, om = adamw_update(grads, o, p, 3e-4)
                return newp, newo, {"loss": lval, **om}
        return fn, (fparams, opt, fbatch)

    cache = M.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    csh = cache_shardings(mesh, cache, shape.global_batch)
    fcache = _fake_tree(cache, csh, device)

    if shape.kind == "prefill":
        from ..train.steps import build_prefill
        step = build_prefill(cfg)

        def fn(p, b, c):
            with use_mesh(mesh, profile=profile):
                return step(p, b, c)
        return fn, (fparams, fbatch, fcache)

    from ..train.steps import build_decode_step
    step = build_decode_step(cfg)

    def fn(p, t, c):
        with use_mesh(mesh, profile=profile):
            return step(p, t, c)
    return fn, (fparams, fbatch["tokens"], fcache)


def _reduced_cfg(cfg: ModelConfig, layers: int,
                 shared_every: Optional[int] = None) -> ModelConfig:
    upd: Dict[str, Any] = {"n_layers": layers}
    if cfg.n_encoder_layers:
        upd["n_encoder_layers"] = layers
    if shared_every is not None:
        upd["shared_attn_every"] = shared_every
    return dataclasses.replace(cfg, **upd)


def _compile(cfg, shape, mesh, unroll, vocab_chunk=0, profile="tp",
             device="cuda"):
    """Trace the cell's step once on rank 0: the reference's keys
    (``compile_s`` is the time to trace)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = build_cell(cfg, shape, mesh, unroll, vocab_chunk,
                              profile, device)
        _, rec = trace_step(fn, args)
    return rec


def layer_costs(cfg: ModelConfig, full: Dict, c2: Dict,
                ce: Optional[Dict] = None):
    """``(per_layer, base, shared_cost, n_shared)`` from the counts of
    ``cfg`` (``full``) and of ``_reduced_cfg(cfg, 2)`` (``c2``); ``ce``,
    hybrid archs only, is ``_reduced_cfg(cfg, 2, shared_every=1)``'s.
    ``base + L * per_layer + n_shared * shared_cost`` gives ``full``."""
    L = cfg.n_layers
    shared_cost = {k: 0.0 for k in COST_KEYS}
    n_shared = n_shared_2 = 0
    if ce is not None:
        shared_cost = {k: max(ce[k] - c2[k], 0.0) for k in COST_KEYS}
        n_shared = -(-L // cfg.shared_attn_every)
        n_shared_2 = -(-2 // cfg.shared_attn_every)
    per_layer = {k: (full[k] - c2[k] - (n_shared - n_shared_2)
                     * shared_cost[k]) / (L - 2) for k in COST_KEYS}
    base = {k: c2[k] - 2.0 * per_layer[k] - n_shared_2 * shared_cost[k]
            for k in COST_KEYS}
    return per_layer, base, shared_cost, n_shared


def run_cell(arch: str, shape: ShapeSpec, multi_pod: bool = False,
             with_costs: bool = True, vocab_chunk: int = 0,
             profile: str = "tp", remat_policy: str = "full",
             decode_no_repeat: bool = False, device="cuda") -> Dict:
    cfg = get_config(arch)
    if remat_policy != "full" or decode_no_repeat:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy,
                                  decode_no_repeat=decode_no_repeat)
    skip = cell_skip_reason(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape.name,
                           "mesh": "2x16x16" if multi_pod else "16x16",
                           "kind": shape.kind, "hw": "H100"}
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    device = resolve_device(device)
    own_group = fake_group()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device.type)
        chips = math.prod(mesh.sizes)
        # ---- feasibility + memory + costs: full depth ----------------------
        full = _compile(cfg, shape, mesh, unroll=False,
                        vocab_chunk=vocab_chunk, profile=profile,
                        device=device)
        rec.update(status="ok", chips=chips, **{f"scan_{k}": v
                                                for k, v in full.items()})
        rec["fits_hbm"] = full["peak_gb_dev"] <= H100.hbm_bytes / 1e9

        if with_costs and not multi_pod:
            # ---- per layer: the diff against L=2 ---------------------------
            def cost(c):
                return _compile(c, shape, mesh, unroll=True,
                                vocab_chunk=vocab_chunk, profile=profile,
                                device=device)
            c2 = cost(_reduced_cfg(cfg, 2))
            ce = (cost(_reduced_cfg(cfg, 2, shared_every=1))
                  if cfg.family == "hybrid" else None)
            per_layer, base, _, _ = layer_costs(cfg, full, c2, ce)
            mf = model_flops(cfg, shape.kind, shape.global_batch,
                             shape.seq_len)
            terms = roofline_terms(full["flops_dev"], full["bytes_dev"],
                                   full["coll_bytes_dev"], chips, mf,
                                   hw=H100)
            rec["roofline"] = terms.as_dict()
            rec["roofline"]["bytes_hlo_global"] = \
                full["bytes_hlo_dev"] * chips
            rec["energy"] = tpu_energy_report(
                full["flops_dev"], full["bytes_dev"],
                full["coll_bytes_dev"], chips, hw=H100)
            rec["per_layer"] = per_layer
            rec["cost_base"] = base
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    finally:
        if own_group:
            import torch.distributed as dist
            dist.destroy_process_group()
    return rec


# ---------------------------------------------------------------------------
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (aliases accepted)")
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--no-costs", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--vocab-chunk", type=int, default=0)
    ap.add_argument("--profile", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--no-repeat", action="store_true",
                    help="grouped-einsum GQA decode")
    ap.add_argument("--tag", default="",
                    help="suffix for the result key (hillclimb variants)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: cuda (default; "
                         "needs a GPU) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES.values()) if args.shape == "all" \
        else [SHAPES[args.shape]]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    out_path = Path(args.out) if args.out else RESULTS_DIR / "dryrun.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results: Dict[str, Dict] = {}
    if out_path.exists() and not args.force:
        results = json.loads(out_path.read_text())

    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                key = f"{arch}|{shape.name}|{'multi' if multi else 'single'}"
                if args.tag:
                    key += f"|{args.tag}"
                if key in results and results[key].get("status") in \
                        ("ok", "skipped") and not args.force:
                    print(f"[cached] {key}")
                    continue
                t0 = time.time()
                rec = run_cell(arch, shape, multi_pod=multi,
                               with_costs=not args.no_costs,
                               vocab_chunk=args.vocab_chunk,
                               profile=args.profile,
                               remat_policy=args.remat,
                               decode_no_repeat=args.no_repeat,
                               device=device)
                if args.tag:
                    rec["tag"] = args.tag
                    rec["levers"] = dict(profile=args.profile,
                                         remat=args.remat,
                                         no_repeat=args.no_repeat,
                                         vocab_chunk=args.vocab_chunk)
                results[key] = rec
                out_path.write_text(json.dumps(results, indent=1))
                status = rec.get("status")
                extra = ""
                if status == "ok" and "roofline" in rec:
                    r = rec["roofline"]
                    extra = (f" dom={r['dominant']}"
                             f" frac={r['roofline_fraction']:.3f}"
                             f" mem={rec['scan_peak_gb_dev']:.2f}GB")
                elif status == "ok":
                    extra = f" mem={rec['scan_peak_gb_dev']:.2f}GB"
                elif status == "error":
                    extra = " " + rec.get("error", "")[:120]
                print(f"[{status}] {key} ({time.time()-t0:.0f}s){extra}",
                      flush=True)

    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in results.values()
                 if r.get("status") == "skipped")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors -> {out_path}")


if __name__ == "__main__":
    main()
