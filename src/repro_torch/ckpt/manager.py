# The JSON helpers are copies of src/repro/ckpt/manager.py (lines 25-70);
# the checkpoint manager is its torch counterpart (that module imports jax).
"""Checkpoint manager: atomic, async, keep-K, resume; and atomic
small-record JSON I/O (shared with the campaign shard stores).

Format, the reference's: one ``step_<N:08d>/`` directory per checkpoint
holding ``params.npz`` (and ``opt_state.npz``) with flattened ``a/b/c``
path -> array entries, keys in ``jax.tree_util`` order, plus a JSON
manifest (step, metadata).  Writes go to ``step_<N>.tmp`` and are
renamed only when complete, so a preempted writer never corrupts the
latest checkpoint.  ``async_save`` snapshots to host memory at once and
writes on a background thread; an error of the write is raised by the
next ``wait`` (or ``save``/``async_save``).

A bf16 tensor is written as the reference writes an ``ml_dtypes``
bfloat16 array: 2-byte ``|V2`` records holding its bits, read back by
the skeleton's dtype, so a checkpoint crosses between the two packages.
``restore`` returns tensors on each skeleton leaf's device and dtype (a
``meta`` leaf: on the CPU), DTensors with its placements for a DTensor
leaf; :func:`restore_resharded` places a checkpoint under new shardings.

On a mesh (a process group of several ranks) the format stays the
reference's, one file of full arrays: a DTensor leaf's snapshot gathers
it (a collective, so every rank calls ``save`` / ``async_save``, and the
gather runs on the caller's thread, never on the writer's), rank 0
alone writes, a synchronous ``save`` returns on every rank once the
checkpoint is published, and ``latest_step`` (so ``restore`` and the
loop's resume) is rank 0's answer on every rank.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import paths, unflatten


def canonical_json(obj: Any) -> str:
    """Canonical (sorted-key, minimal-separator) JSON — the checksum and
    content-comparison form.  ``repr``-round-trip floats, so a payload
    survives write -> read -> re-checksum bit-exactly."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=True)


def payload_checksum(obj: Any) -> str:
    """sha256 over the canonical JSON form of ``obj``."""
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()


def atomic_write_text(path: str, text: str) -> str:
    """Write ``text`` via tmp-file + fsync + rename.

    Same publish discipline as checkpoint directories: a reader never
    observes a half-written file, and a writer killed mid-write leaves
    only a ``.tmp`` turd the next writer overwrites.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)          # atomic publish
    return path


def atomic_write_json(path: str, obj: Any, *,
                      indent: Optional[int] = 1) -> str:
    """Write ``obj`` as JSON with :func:`atomic_write_text` discipline.

    Encodes to a string first (``json.dump``-to-file pins the
    pure-Python incremental encoder; ``dumps`` takes the C path when it
    can), then publishes atomically.
    """
    return atomic_write_text(path, json.dumps(obj, indent=indent))


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# The checkpoint manager
# ---------------------------------------------------------------------------
_BF16_RECORD = np.dtype("V2")


def _ranks() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _to_numpy(t: torch.Tensor, keep: bool = True) -> Optional[np.ndarray]:
    """A host copy of ``t`` (never a view: the train step writes its
    tensors in place; a DTensor gathered whole); bf16 as ``|V2`` records
    of its bits.  With ``keep`` false (a rank that does not write) only
    a DTensor's gather, a collective every rank takes part in, and
    ``None``."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if not keep:
        return None
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _flatten(tree: Any, keep: bool = True) -> Optional[Dict[str, Any]]:
    if tree is None:
        return None
    return {key: _to_numpy(leaf, keep) for key, leaf in paths(tree)}


def _tensor_like(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, distribute_tensor
    if arr.dtype == _BF16_RECORD:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if isinstance(leaf, DTensor):
        # every rank read the same file: each keeps its own shard
        return distribute_tensor(t.to(leaf.dtype), leaf.device_mesh,
                                 leaf.placements, src_data_rank=None)
    device = "cpu" if leaf.device.type == "meta" else leaf.device
    return t.to(device=device, dtype=leaf.dtype)


def _unflatten_into(skeleton: Any, flat: Dict[str, np.ndarray]) -> Any:
    """``skeleton``'s tree with each leaf read from ``flat`` (checked for
    presence and shape) as a tensor on the leaf's device and dtype."""
    def one(key, leaf):
        if key not in flat:
            raise KeyError(f"checkpoint missing parameter {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key!r}: checkpoint "
                             f"{arr.shape} vs model {tuple(leaf.shape)}")
        return _tensor_like(arr, leaf)
    return unflatten({key: one(key, leaf) for key, leaf in paths(skeleton)})


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, params: Any, opt_state: Any = None,
             metadata: Optional[Dict] = None) -> str:
        self.wait()
        rank, world = _ranks()
        flat = _flatten(params, keep=rank == 0)
        flat_opt = _flatten(opt_state, keep=rank == 0)
        final = self._path(step)
        if rank == 0:
            self._write_flat(step, flat, flat_opt, metadata or {})
        if world > 1:
            import torch.distributed as dist
            dist.barrier()
        return final

    def async_save(self, step: int, params: Any, opt_state: Any = None,
                   metadata: Optional[Dict] = None) -> None:
        """Snapshot to host now; write on a background thread."""
        self.wait()
        rank = _ranks()[0]
        flat = _flatten(params, keep=rank == 0)
        flat_opt = _flatten(opt_state, keep=rank == 0)
        md = dict(metadata or {})
        if rank != 0:
            return

        def work():
            try:
                self._write_flat(step, flat, flat_opt, md)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def _write_flat(self, step, flat, flat_opt, metadata) -> str:
        final = self._path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "params.npz"), **flat)
        if flat_opt is not None:
            np.savez(os.path.join(tmp, "opt_state.npz"), **flat_opt)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "metadata": metadata}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest published step; with several ranks rank 0's (every
        rank calls it)."""
        steps = self.list_steps()
        latest = steps[-1] if steps else None
        if _ranks()[1] > 1:
            import torch.distributed as dist
            box = [latest]
            dist.broadcast_object_list(box, src=0)
            latest = box[0]
        return latest

    def restore(self, skeleton_params: Any, skeleton_opt: Any = None,
                step: Optional[int] = None) -> Tuple[Any, Any, Dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._path(step)
        with np.load(os.path.join(d, "params.npz")) as z:
            params = _unflatten_into(skeleton_params, dict(z))
        opt = None
        if skeleton_opt is not None:
            with np.load(os.path.join(d, "opt_state.npz")) as z:
                opt = _unflatten_into(skeleton_opt, dict(z))
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        return params, opt, manifest


def restore_resharded(manager: CheckpointManager, skeleton: Any,
                      shardings: Any, step: Optional[int] = None) -> Any:
    """Elastic restore: the checkpointed parameters placed under NEW
    shardings (a tree of :class:`repro_torch.distributed.sharding.
    NamedSharding`, as ``param_shardings`` gives; ``skeleton`` gives
    paths, shapes and dtypes, its leaves may be ``meta``).  Every rank
    reads the file and keeps its own shards: no collective moves the
    values."""
    from ..distributed.sharding import distribute_tree
    params, _, _ = manager.restore(skeleton, None, step)
    return distribute_tree(params, shardings, src_data_rank=None)
