"""Named host spans at the layer boundaries of the LM stack, for a
``torch.profiler`` trace.

``span(name)`` is a profiler range named ``repro_torch.<name>`` while a
profiler is collecting, and one shared null context otherwise: with
tracing off a boundary costs one bool check, makes no range and reads
nothing from the device.  The range is a plain host operation
(``torch._C._profiler._RecordFunctionFast``), not a user annotation
(``torch.profiler.record_function``): the profiler copies a user
annotation onto the device's timeline as a row that spans the kernels
under it, which a reading of device time would count as device
activity.  The ranges lie on the profiler's host clock beside the aten
operations and kernel launches they enclose, so a trace can charge each
kernel to the innermost span its launch ran in; a backward kernel goes
to the span of the forward operation that made its autograd node (the
node's ``sequence_nr`` and ``fwd_thread_id``).  The spans are flat: none
opens inside another, except the final norm inside ``logits``.  They
mark the self-attention LM's training step and prefill; the decode step
opens only those of the functions it shares with them.

=============  ===========================================================
``embed``      the token embedding (``models/model.py::_embed_in``)
``norm``       every LayerNorm / RMSNorm call (``models/common.py::norm``)
``attn_proj``  the Q, K, V projections and head splits, the merge of the
               heads and the output projection
``rope``       the rotary embedding of Q and K
``attention``  the attention core: scores, mask, softmax, P.V
``mlp``        the feed-forward block, dense or MoE
``logits``     the final norm and the tied head
``loss``       the next-token labels and the cross entropy
``schedule``   the learning-rate schedule
``adamw``      the optimizer step (norm, clip, moments, update)
``kv_cache``   prefill's writes of K and V into the cache
=============  ===========================================================
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."

#: every span name, in the order of a training step
SPANS = ("embed", "norm", "attn_proj", "rope", "attention", "mlp",
         "logits", "loss", "schedule", "adamw", "kv_cache")

_OFF = contextlib.nullcontext()


def span(name: str):
    """``repro_torch.<name>`` as a profiler range while a profiler is
    collecting; a null context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _OFF
