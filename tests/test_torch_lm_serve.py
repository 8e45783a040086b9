"""The port's serving path against the reference's, for all ten
architectures (``repro_torch.models.model`` vs ``repro.models.model``).

Each reduced architecture (f32) runs ``forward`` over ``S = 48``
positions, then ``prefill`` of those 48 and three ``decode_step``s fed
positions 48-50 (tokens, or embeddings for vlm; whisper's 16 stub audio
frames too), in the reference (eagerly, as ``tests/test_archs.py`` runs
it) and in the port on the CPU with the reference's own weights carried
across.  The logits of every call and every cache entry after every
call (K/V rings, SSM conv and state, ``enc_out``, ``pos``) are held to
``max|port - ref| <= 1e-4 max|ref|``; ``pos`` exactly.  At ``S = 48``
the reduced mixtral and zamba2 (window 32) prefill past their window,
so the prefill's ring roll is held too.  The reference runs once per
architecture (``run_pair``'s cache).

Also: the port's own continuity (``prefill(S)`` and one decode step
against ``forward(S + 1)`` within ``2e-2 max(scale, 1)``, the
reference's rule), ``decode_step``'s in-place cache, the serving steps
and the entry point's ``main`` on the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as RM
from repro.configs import ARCH_IDS, get_config, reduced
import repro_torch.models.model as PM
from repro_torch.launch import serve_lm
from repro_torch.models.convert import params_from_numpy, to_numpy
from repro_torch.train import build_decode_step, build_prefill

B, S, STEPS = 2, 48, 3
F32 = 1e-4


def inputs(cfg, b, n, seed):
    """``n`` positions of model input from a numpy seed, as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal((b, n, cfg.d_model),
                                            dtype=np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, n)).astype(np.int32)
    if cfg.family == "encdec":
        out["audio_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return out


def _split(batch, s, steps):
    key = "embeds" if "embeds" in batch else "tokens"
    prompt = dict(batch, **{key: batch[key][:, :s]})
    return prompt, [batch[key][:, s + i:s + i + 1] for i in range(steps)]


def run_pair(cfg, b=B, s=S, steps=STEPS, max_seq=None, seed=0):
    """The reference and the port through forward(s), prefill(s) and
    ``steps`` decode steps on the same weights and inputs: for each,
    a list of (name, logits, cache) as numpy, the caches copied after
    each call."""
    max_seq = max_seq or s + 8
    params = RM.init_params(cfg, jax.random.PRNGKey(seed))
    ported = params_from_numpy(jax.tree.map(np.asarray, params),
                               device="cpu")
    prompt, nexts = _split(inputs(cfg, b, s + steps, seed), s, steps)

    def jx(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    def tt(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}

    ref = [("forward", np.asarray(RM.forward(params, jx(prompt), cfg)),
            None)]
    logits, cache = RM.prefill(params, jx(prompt),
                               RM.init_cache(cfg, b, max_seq), cfg)
    ref.append(("prefill", np.asarray(logits),
                jax.tree.map(np.asarray, cache)))
    for i, nxt in enumerate(nexts):
        logits, cache = RM.decode_step(params, jnp.asarray(nxt), cache, cfg)
        ref.append((f"decode{i}", np.asarray(logits),
                    jax.tree.map(np.asarray, cache)))

    port = []
    with torch.inference_mode():
        port.append(("forward", to_numpy(PM.forward(ported, tt(prompt),
                                                    cfg)), None))
        logits, cache = PM.prefill(ported, tt(prompt),
                                   PM.init_cache(cfg, b, max_seq,
                                                 device="cpu"), cfg)
        port.append(("prefill", to_numpy(logits), to_numpy(cache)))
        for i, nxt in enumerate(nexts):
            logits, cache = PM.decode_step(ported, torch.from_numpy(nxt),
                                           cache, cfg)
            port.append((f"decode{i}", to_numpy(logits), to_numpy(cache)))
    return ref, port


def check_pair(ref, port, tol, calls=None):
    """Every call's logits and cache entries within ``tol * max|ref|``
    (``pos`` exactly); returns the worst relative error."""
    worst = 0.0
    for (name, r_log, r_cache), (_, p_log, p_cache) in zip(ref, port):
        if calls and name not in calls:
            continue
        pairs = [("logits", p_log, r_log)]
        if r_cache is not None:
            assert sorted(p_cache) == sorted(r_cache), name
            assert int(p_cache["pos"]) == int(r_cache["pos"]), name
            pairs += [(k, p_cache[k], r_cache[k]) for k in r_cache
                      if k != "pos"]
        for what, p, r in pairs:
            r = np.asarray(r, np.float32)
            assert p.shape == r.shape, (name, what, p.shape, r.shape)
            assert np.isfinite(p).all(), (name, what)
            rel = float(np.abs(p - r).max()) / max(float(np.abs(r).max()),
                                                   1e-30)
            assert rel <= tol, (name, what, rel)
            worst = max(worst, rel)
    return worst


@functools.lru_cache(maxsize=None)
def _f32(arch):
    return run_pair(reduced(get_config(arch)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    check_pair(*_f32(arch), F32, calls=("forward",))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_reference(arch):
    ref, port = _f32(arch)
    check_pair(ref, port, F32, calls=("prefill",))
    cfg = reduced(get_config(arch))
    if cfg.sliding_window:          # the ring was rolled: S > window
        assert ref[1][2]["kv_k"].shape[2] == cfg.sliding_window < S


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_three_decode_steps_match_reference(arch):
    check_pair(*_f32(arch), F32,
               calls=tuple(f"decode{i}" for i in range(STEPS)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_continuity_in_the_port(arch):
    """prefill(S) + decode(1) equals forward(S+1) at the last position
    (MoE at capacity factor 8.0, so no token is dropped), the rule of
    the reference's ``tests/test_archs.py:58-85``."""
    cfg = reduced(get_config(arch))
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    params = PM.init_params(cfg, 0, device="cpu")
    full = {k: torch.from_numpy(v) for k, v in
            inputs(cfg, B, 65, 1).items()}
    prompt, (nxt,) = _split(full, 64, 1)
    with torch.inference_mode():
        ref = PM.forward(params, full, cfg)[:, 64]
        _, cache = PM.prefill(params, prompt,
                              PM.init_cache(cfg, B, 72, device="cpu"), cfg)
        dlog, _ = PM.decode_step(params, nxt, cache, cfg)
    scale = float(ref.abs().max())
    err = float((dlog[:, 0] - ref).abs().max())
    assert err < 2e-2 * max(scale, 1.0), (arch, err, scale)


@pytest.mark.parametrize("arch", ["qwen2_7b", "zamba2_1p2b",
                                  "falcon_mamba_7b"])
def test_decode_step_writes_the_cache_in_place(arch):
    """``decode_step`` writes its row (and SSM state) into the caller's
    tensors and returns a new dict holding them, with ``pos + 1``."""
    cfg = reduced(get_config(arch))
    params = PM.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in inputs(cfg, B, 9, 2).items()}
    prompt, (nxt,) = _split(batch, 8, 1)
    with torch.inference_mode():
        _, cache = PM.prefill(params, prompt,
                              PM.init_cache(cfg, B, 16, device="cpu"), cfg)
        before = {k: v.clone() for k, v in cache.items()}
        _, new = PM.decode_step(params, nxt, cache, cfg)
    assert new is not cache and int(cache["pos"]) == 8
    assert int(new["pos"]) == 9 and new["pos"].dtype == torch.int32
    for k in cache:
        if k == "pos":
            continue
        assert new[k] is cache[k], k
        assert not torch.equal(cache[k], before[k]), k
    if "kv_k" in cache:             # slot 8 written, the rest untouched
        changed = (cache["kv_k"] != before["kv_k"]).any(-1).any(1)
        assert changed[..., 8].all() and not changed[..., :8].any()
        assert not changed[..., 9:].any()


def test_serving_steps_equal_the_model_calls():
    cfg = reduced(get_config("mixtral_8x7b"))
    params = PM.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in inputs(cfg, B, 41, 3).items()}
    prompt, (nxt,) = _split(batch, 40, 1)
    logits, cache = build_prefill(cfg)(
        params, prompt, PM.init_cache(cfg, B, 48, device="cpu"))
    assert logits.is_inference()
    step, _ = build_decode_step(cfg)(params, nxt, cache)
    with torch.inference_mode():
        l2, c2 = PM.prefill(params, prompt,
                            PM.init_cache(cfg, B, 48, device="cpu"), cfg)
        s2, _ = PM.decode_step(params, nxt, c2, cfg)
    assert torch.equal(logits, l2) and torch.equal(step, s2)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "whisper_medium",
                                  "falcon_mamba_7b"])
def test_entry_point_main_on_the_cpu(arch, capsys):
    assert serve_lm.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "40", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch} family=")
    assert out[1].startswith("prefill 40 tokens x2: ") and \
        "ms/token" in out[1]
    toks = eval(out[2].split(":", 1)[1])
    assert len(toks) == 4 and all(0 <= t < 128 for t in toks)


def test_entry_point_refuses_vlm_and_needs_a_gpu_by_default(monkeypatch):
    with pytest.raises(SystemExit, match="text arch"):
        serve_lm.main(["--arch", "llava_next_34b", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.main(["--arch", "qwen2_7b"])
