"""The port's serving path against the reference's at its edges: bf16
(one reduced architecture a family), the sliding-window ring as decode
wraps it, and a full-attention cache that overflows.

Same method as ``tests/test_torch_lm_serve.py`` (whose ``run_pair`` and
``check_pair`` run it): the reference's weights carried across, inputs
from a numpy seed, every call's logits and cache entries compared.
Bounds: bf16 ``max|port - ref| <= 2e-2 max|ref|``; f32 ``1e-4``.
"""
import dataclasses

import pytest

from repro.configs import get_config, reduced
from test_torch_lm_serve import check_pair, run_pair

#: one reduced architecture a family
FAMILIES = {"dense": "qwen2_7b", "vlm": "llava_next_34b",
            "moe": "mixtral_8x7b", "ssm": "falcon_mamba_7b",
            "hybrid": "zamba2_1p2b", "encdec": "whisper_medium"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_matches_reference(family):
    cfg = dataclasses.replace(reduced(get_config(FAMILIES[family])),
                              dtype="bfloat16")
    assert cfg.family == family
    check_pair(*run_pair(cfg, s=40, steps=3), 2e-2)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "zamba2_1p2b"])
def test_decode_wraps_the_ring(arch):
    """A 62-token prompt over a window of 32 (the prefill rolls the ring
    by 30), then decode at positions 62, 63, 64: slots 30, 31, then 0."""
    cfg = reduced(get_config(arch))
    assert cfg.sliding_window == 32
    ref, port = run_pair(cfg, s=62, steps=3, max_seq=72)
    assert ref[1][2]["kv_k"].shape[2] == 32
    check_pair(ref, port, 1e-4)


@pytest.mark.parametrize("arch", ["qwen2_7b", "whisper_medium"])
def test_full_cache_overflow_rewrites_its_last_slot(arch):
    """A cache of 41 slots, a 40-token prompt, three decode steps: the
    second and third overflow; the reference's ``dynamic_update_slice``
    clamps them to slot 40, and so does the port (no error)."""
    cfg = reduced(get_config(arch))
    ref, port = run_pair(cfg, s=40, steps=3, max_seq=41)
    assert ref[-1][2]["kv_k"].shape[2] == 41 and int(ref[-1][2]["pos"]) == 43
    check_pair(ref, port, 1e-4)
