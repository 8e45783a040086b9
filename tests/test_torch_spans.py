"""The LM stack's profiler spans (``repro_torch.spans``): where they
open, how often, that they change no value, that they cost no
``record_function`` with tracing off, and that a trace can charge the
backward to them through the autograd nodes' ``sequence_nr``.  On the
CPU, at a tiny OLMo shape (non-parametric LayerNorm, SwiGLU, tied
head)."""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init
from repro_torch.train import build_decode_step, build_prefill, \
    build_train_step
from repro_torch.train import steps as S
from repro_torch.tree import paths

EVAL = "autograd::engine::evaluate_function: "

# the spans a layer opens in one pass, and those a step or call opens once
PER_LAYER = {"norm": 2, "attn_proj": 2, "rope": 1, "attention": 1, "mlp": 1}


def _cfg(dtype="bfloat16"):
    return ModelConfig(arch_id="olmo_tiny", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                       vocab=512, non_parametric_ln=True, dtype=dtype,
                       attn_q_chunk=8)


def _tokens(seed=0, B=2, S_=16):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 512, (B, S_), generator=g)


def _state(cfg):
    params = M.init_params(cfg, 3, device="cpu")
    return params, adamw_init(params)


def _flat(tree):
    return dict(paths(tree))


def _events(prof):
    return prof.profiler.kineto_results.events()


def _span_counts(prof):
    return collections.Counter(
        e.name()[len(spans.PREFIX):] for e in _events(prof)
        if e.name().startswith(spans.PREFIX))


def _train_step(cfg, params, opt, tokens, traced):
    step = build_train_step(cfg, vocab_chunk=128)
    if not traced:
        return step(params, opt, {"tokens": tokens}, 0), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(params, opt, {"tokens": tokens}, 0)
    return out, prof


def test_span_names():
    assert len(set(spans.SPANS)) == len(spans.SPANS) == 11
    assert set(PER_LAYER) < set(spans.SPANS)


def test_spans_are_host_operations_not_annotations():
    """A span is a plain operation in the trace: the profiler copies a
    user annotation onto the device's timeline, a plain one it does
    not."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("mlp"):
            torch.ones(2) + 1
    rows = [e for e in _events(prof) if e.name() == spans.PREFIX + "mlp"]
    assert len(rows) == 1
    if hasattr(rows[0], "activity_type"):
        assert rows[0].activity_type() == "cpu_op"


def test_train_step_opens_each_span():
    cfg = _cfg()
    params, opt = _state(cfg)
    _, prof = _train_step(cfg, params, opt, _tokens(), traced=True)
    # each layer runs twice: the forward and its recompute (remat full);
    # the final norm opens inside ``logits``
    want = {k: 2 * cfg.n_layers * n for k, n in PER_LAYER.items()}
    want["norm"] += 1
    want.update(embed=1, logits=1, loss=1, schedule=1, adamw=1)
    assert _span_counts(prof) == want


def test_prefill_opens_each_span():
    cfg = _cfg()
    params, _ = _state(cfg)
    cache = M.init_cache(cfg, 2, 24, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build_prefill(cfg)(params, {"tokens": _tokens()}, cache)
    want = {k: cfg.n_layers * n for k, n in PER_LAYER.items()}
    want["norm"] += 1
    want.update(embed=1, logits=1, kv_cache=cfg.n_layers + 1)
    assert _span_counts(prof) == want


def test_decode_opens_its_spans():
    """Decode opens only the spans of the functions it shares with the
    training step and prefill: none of its own (no embed, attention
    core or cache write)."""
    cfg = _cfg()
    params, _ = _state(cfg)
    cache = M.init_cache(cfg, 2, 24, device="cpu")
    _, cache = build_prefill(cfg)(params, {"tokens": _tokens()}, cache)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build_decode_step(cfg)(params, _tokens(1, S_=1), cache)
    want = {k: cfg.n_layers * n for k, n in PER_LAYER.items()
            if k != "attention"}
    want["norm"] += 1
    want.update(logits=1)
    assert _span_counts(prof) == want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_step_bit_identical_under_profiler(dtype):
    cfg = _cfg(dtype)
    tokens = _tokens(4)
    results = []
    for traced in (False, True):
        params, opt = _state(cfg)
        (params, opt, m), _ = _train_step(cfg, params, opt, tokens, traced)
        results.append((m, _flat(params), _flat(opt)))
    (m0, p0, o0), (m1, p1, o1) = results
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(m0[k], m1[k]), k
    for a, b in ((p0, p1), (o0, o1)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_gradients_bit_identical_under_profiler():
    cfg = _cfg()
    params, _ = _state(cfg)
    batch = {"tokens": _tokens(5)}
    (loss0, _), g0 = S.value_and_grad(params, batch, cfg, 128)
    with profile(activities=[ProfilerActivity.CPU]):
        (loss1, _), g1 = S.value_and_grad(params, batch, cfg, 128)
    assert torch.equal(loss0, loss1)
    g0, g1 = _flat(g0), _flat(g1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_prefill_bit_identical_under_profiler():
    cfg = _cfg()
    params, _ = _state(cfg)
    cache = M.init_cache(cfg, 2, 24, device="cpu")
    fn = build_prefill(cfg)
    tokens = _tokens(6)
    logits0, c0 = fn(params, {"tokens": tokens}, cache)
    with profile(activities=[ProfilerActivity.CPU]):
        logits1, c1 = fn(params, {"tokens": tokens}, cache)
    assert torch.equal(logits0, logits1)
    assert c0.keys() == c1.keys()
    for k in c0:
        assert torch.equal(c0[k], c1[k]), k


def test_no_range_with_tracing_off(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert spans.span("norm") is spans.span("adamw")
    cfg = _cfg()
    params, opt = _state(cfg)
    _train_step(cfg, params, opt, _tokens(), traced=False)
    cache = M.init_cache(cfg, 2, 24, device="cpu")
    _, cache = build_prefill(cfg)(params, {"tokens": _tokens()}, cache)
    build_decode_step(cfg)(params, _tokens(1, S_=1), cache)


def _innermost_span(evs):
    """{event index: innermost ``repro_torch.`` span enclosing it on its
    thread} for the forward operations (no backward node's range)."""
    rows = [(e.start_thread_id(), e.start_ns(), e.end_ns(), e.name())
            for e in evs if e.name().startswith(spans.PREFIX)]
    out = {}
    for i, e in enumerate(evs):
        if e.fwd_thread_id() or e.sequence_nr() < 0:
            continue
        tid, t = e.start_thread_id(), e.start_ns()
        inside = [(s, n) for th, s, end, n in rows
                  if th == tid and s <= t <= end]
        out[i] = max(inside)[1][len(spans.PREFIX):] if inside else None
    return out


def test_backward_maps_to_forward_spans():
    """Each backward node finds the forward operation that made it by
    (``fwd_thread_id``, ``sequence_nr``); the nodes of every layer
    function's operations land in that function's span, and only the
    residual adds and the unbind of the stacked weights fall outside."""
    cfg = _cfg()
    params, opt = _state(cfg)
    _, prof = _train_step(cfg, params, opt, _tokens(), traced=True)
    evs = list(_events(prof))
    span_of = _innermost_span(evs)
    made = {}           # (thread, sequence_nr) -> the last op to carry it
    for i in sorted(span_of, key=lambda i: evs[i].start_ns()):
        made[(evs[i].start_thread_id(), evs[i].sequence_nr())] = i
    charged = collections.defaultdict(set)
    for e in evs:
        if not e.name().startswith(EVAL) or e.sequence_nr() < 0:
            continue
        i = made.get((e.fwd_thread_id(), e.sequence_nr()))
        assert i is not None, e.name()
        charged[span_of[i]].add(e.name()[len(EVAL):])
    assert charged.pop(None) == {"AddBackward0", "UnbindBackward0"}
    assert set(charged) == set(spans.SPANS) - {"schedule", "adamw",
                                                "kv_cache"}
    assert {"SoftmaxBackward0", "BmmBackward0", "WhereBackward0"} <= \
        charged["attention"]
    assert {"RsqrtBackward0", "MeanBackward1"} <= charged["norm"]
    assert {"CatBackward0", "MulBackward0"} <= charged["rope"]
    assert {"ExpBackward0", "ReciprocalBackward0", "BmmBackward0"} <= \
        charged["mlp"]
    assert "EmbeddingBackward0" in charged["embed"]
    assert "BmmBackward0" in charged["logits"]
    assert "LogBackward0" in charged["loss"]
