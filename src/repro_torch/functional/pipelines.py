"""Executable versions of the paper's pipelines, built on the port's ops.

The torch counterpart of ``repro/functional/pipelines.py``.  These run the
*numbers*, the energy model runs the *Joules*.  Every function follows
its input tensors' device: on a CUDA tensor each kernel (K5 binning, K6
stencil_conv, K7 frame_event, K8 matmul) launches or raises, and no twin
runs; a CPU tensor is the caller asking for the CPU, where the kernels'
plain-torch twins run.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops

SOBEL_X = torch.tensor([[1., 0., -1.], [2., 0., -2.], [1., 0., -1.]])

#: SOBEL_X and its transpose, contiguous f32, by device
_SOBEL: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _sobel(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    hit = _SOBEL.get(device)
    if hit is None:
        sx = SOBEL_X.to(device)
        hit = _SOBEL[device] = (sx, sx.T.contiguous())
    return hit


def fig5_pipeline(image: torch.Tensor,
                  use_pallas: bool = True) -> torch.Tensor:
    """Fig. 5: 2x2 binning then 3x3 edge detection (Sobel magnitude proxy)."""
    binned = ops.binning(image, factor=2, use_pallas=use_pallas)
    sx, sy = _sobel(binned.device)
    gx = ops.stencil_conv(binned, sx, use_pallas=use_pallas)
    gy = ops.stencil_conv(binned, sy, use_pallas=use_pallas)
    return gx.abs() + gy.abs()


def edgaze_frontend(cur: torch.Tensor, prev_binned: torch.Tensor,
                    threshold: float = 0.05, use_pallas: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ed-Gaze S1+S2 (Fig. 8b): 2x2 downsample, frame delta -> event map.

    Returns (event_map, new_prev) so the caller can roll the frame buffer.
    """
    binned = ops.binning(cur, factor=2, use_pallas=use_pallas)
    events = ops.frame_event(binned, prev_binned, threshold=threshold,
                             use_pallas=use_pallas)
    return events, binned


def rhythmic_pixel_frontend(image: torch.Tensor, tile: int = 16,
                            keep_fraction: float = 0.5) -> torch.Tensor:
    """Rhythmic Pixel Regions (Fig. 8a) compare&sample proxy: keep the most
    active tiles (by local gradient energy) and zero the rest.

    The reference runs this pipeline's stencils on its oracle; here they
    run on K6 wherever the image lies, the same function.  Each tile's
    score adds its columns and then its rows in order with elementwise
    adds, so it is the same number on every device (a reduction kernel
    adds in its own order, and the mask could flip at a near-tie).
    """
    sx, sy = _sobel(image.device)
    gx = ops.stencil_conv(image, sx)
    gy = ops.stencil_conv(image, sy)
    act = F.pad(gx.abs() + gy.abs(), (1, 1, 1, 1))
    h, w = act.shape
    th, tw = h // tile, w // tile
    strips = act[: th * tile, : tw * tile].reshape(th * tile, tw, tile)
    rows = strips[..., 0]
    for j in range(1, tile):
        rows = rows + strips[..., j]
    rows = rows.reshape(th, tile, tw)
    score = rows[:, 0]
    for i in range(1, tile):
        score = score + rows[:, i]
    score = score.reshape(-1)
    k = max(int(score.numel() * keep_fraction), 1)
    cutoff = torch.sort(score).values[-k]
    keep = (score >= cutoff).reshape(th, tw)
    mask = keep[:, None, :, None].expand(th, tile, tw, tile).reshape(
        th * tile, tw * tile)
    out = torch.zeros_like(image)
    out[: th * tile, : tw * tile] = image[: th * tile, : tw * tile] * mask
    return out


def simple_dnn(events: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               use_pallas: bool = True) -> torch.Tensor:
    """Ed-Gaze S3 proxy: tiny 2-layer MLP over flattened event features."""
    x = events.reshape(1, -1)
    h = ops.matmul(x, w1, use_pallas=use_pallas)
    h = torch.relu(h)
    return ops.matmul(h, w2, use_pallas=use_pallas)
