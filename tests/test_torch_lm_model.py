"""The port's LM configs, parameter trees, initialiser, caches and the
numpy carrier against the reference's (``repro_torch.configs``,
``repro_torch.models.model``, ``repro_torch.models.convert``).

* the configs are verbatim copies: every published config and its
  reduced form equal the reference's field for field;
* ``param_shapes`` gives the reference's paths, shapes and dtypes for
  every published config, its count within 2% of the analytic
  ``param_count`` (the reference's own test, ``tests/test_archs.py``);
  ``abstract_params`` and ``abstract_cache`` hold them as ``meta``
  tensors;
* ``init_params`` sets the reference's constants (norms and ``d_skip``
  ones, biases zeros, mamba1's ``a_log`` = log(1..N)) exactly and draws
  the rest at std ``fan_in ** -0.5``, reproducibly from a seed or a
  generator; ``init_cache`` equals the reference's zeros slot for slot;
* ``params_from_numpy`` carries the reference's f32 and bf16 weights in
  bit for bit, ``to_numpy`` back (bf16 widened to f32, exactly).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.model as RM
import repro_torch.configs as PC
import repro_torch.models.model as PM
from repro_torch.models.convert import cache_from_numpy, params_from_numpy, \
    to_numpy

ARCHS = RC.ARCH_IDS


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_registry_is_the_references():
    assert PC.ARCH_IDS == RC.ARCH_IDS and PC.ALIASES == RC.ALIASES
    for alias in RC.ALIASES:
        assert dataclasses.asdict(PC.get_config(alias)) == \
            dataclasses.asdict(RC.get_config(alias))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    p, r = PC.get_config(arch), RC.get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert dataclasses.asdict(PC.reduced(p)) == \
        dataclasses.asdict(RC.reduced(r))
    assert (p.head_dim, p.d_inner, p.has_attention, p.sub_quadratic,
            p.param_count(), p.active_param_count()) == \
        (r.head_dim, r.d_inner, r.has_attention, r.sub_quadratic,
         r.param_count(), r.active_param_count())
    assert set(PC.all_configs()) == set(RC.all_configs())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_the_references(arch):
    cfg = RC.get_config(arch)
    r, p = RM.param_shapes(cfg), PM.param_shapes(cfg)
    assert list(p) == list(r)
    for path, (shape, dtype) in r.items():
        assert p[path][0] == shape, path
        assert str(p[path][1]).replace("torch.", "") == np.dtype(dtype).name
    actual = sum(int(np.prod(s)) for s, _ in p.values())
    assert abs(actual - cfg.param_count()) / actual < 0.02


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_cache_are_meta(arch):
    cfg = RC.get_config(arch)
    ap = _flat(PM.abstract_params(cfg))
    assert all(t.device.type == "meta" for t in ap.values())
    assert {k: tuple(t.shape) for k, t in ap.items()} == \
        {k: s for k, (s, _) in PM.param_shapes(cfg).items()}
    rc = RM.abstract_cache(cfg, 4, 1056)
    pc = PM.abstract_cache(cfg, 4, 1056)
    assert sorted(pc) == sorted(rc)
    for k, t in pc.items():
        assert t.device.type == "meta" and tuple(t.shape) == rc[k].shape
        assert str(t.dtype).replace("torch.", "") == np.dtype(
            rc[k].dtype).name, k


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_constants_and_scale(arch):
    cfg = RC.reduced(RC.get_config(arch))
    ref = _flat(jax.tree.map(np.asarray,
                             RM.init_params(cfg, jax.random.PRNGKey(0))))
    flat = _flat(PM.init_params(cfg, 0, device="cpu"))
    assert sorted(flat) == sorted(ref)
    for path, t in flat.items():
        r = ref[path]
        assert tuple(t.shape) == r.shape and t.dtype == torch.float32
        name = path.split("/")[-1]
        if "norm" in name or name in ("bq", "bk", "bv", "conv_b",
                                      "dt_bias", "a_log", "d_skip"):
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-6, atol=0)
        else:
            fan_in = t.shape[-2] if t.ndim >= 2 else t.shape[-1]
            std = float(t.std())
            assert abs(std - fan_in ** -0.5) < 0.25 * fan_in ** -0.5, path


def test_init_params_reproducible_from_seed_or_generator():
    cfg = RC.reduced(RC.get_config("mixtral_8x7b"))
    a = _flat(PM.init_params(cfg, 3, device="cpu"))
    b = _flat(PM.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu"))
    c = _flat(PM.init_params(cfg, 4, device="cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers/wq"], c["layers/wq"])
    bf = _flat(PM.init_params(dataclasses.replace(cfg, dtype="bfloat16"), 3,
                              device="cpu"))
    assert all(t.dtype == torch.bfloat16 for t in bf.values())
    assert torch.equal(bf["layers/wq"], a["layers/wq"].to(torch.bfloat16))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_equals_the_references(arch):
    cfg = RC.reduced(RC.get_config(arch))
    for b, max_seq in ((2, 56), (1, 20)):
        r = jax.tree.map(np.asarray, RM.init_cache(cfg, b, max_seq))
        p = PM.init_cache(cfg, b, max_seq, device="cpu")
        assert sorted(p) == sorted(r)
        assert p["pos"].dtype == torch.int32 and p["pos"].shape == ()
        for k, t in to_numpy(p).items():
            assert t.dtype == r[k].dtype, k
            np.testing.assert_array_equal(t, r[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3_4b", "falcon_mamba_7b",
                                  "zamba2_1p2b", "whisper_medium"])
def test_params_from_numpy_is_bit_for_bit(arch, dtype):
    cfg = dataclasses.replace(RC.reduced(RC.get_config(arch)), dtype=dtype)
    ref = jax.tree.map(np.asarray, RM.init_params(cfg, jax.random.PRNGKey(1)))
    port = params_from_numpy(ref, device="cpu")
    flat_r, flat_p = _flat(ref), _flat(port)
    assert sorted(flat_p) == sorted(flat_r)
    bits = {"float32": (np.uint32, torch.int32),
            "bfloat16": (np.uint16, torch.int16)}[dtype]
    for path, t in flat_p.items():
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(
            t.view(bits[1]).numpy().view(bits[0]), flat_r[path].view(bits[0]))
    back = _flat(to_numpy(port))
    for path, a in back.items():
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, flat_r[path].astype(np.float32))


def test_cache_from_numpy_and_back():
    cfg = dataclasses.replace(RC.reduced(RC.get_config("zamba2_1p2b")),
                              dtype="bfloat16")
    r = jax.tree.map(np.asarray, RM.init_cache(cfg, 2, 40))
    rng = np.random.default_rng(0)
    r = {k: (v + rng.standard_normal(v.shape).astype(v.dtype)
             if v.ndim else np.asarray(17, np.int32)) for k, v in r.items()}
    p = cache_from_numpy(r, device="cpu")
    assert p["pos"].dtype == torch.int32 and int(p["pos"]) == 17
    assert p["ssm"].dtype == torch.float32
    assert p["kv_k"].dtype == p["conv"].dtype == torch.bfloat16
    for k, a in to_numpy(p).items():
        np.testing.assert_array_equal(a, r[k].astype(a.dtype))
    # a copy, not a view of the caller's arrays
    p["ssm"].zero_()
    assert np.abs(r["ssm"]).max() > 0


@pytest.mark.parametrize("unroll,remat", [(True, True), (False, False)])
def test_unroll_and_remat_change_no_value(unroll, remat):
    cfg = RC.reduced(RC.get_config("zamba2_1p2b"))
    params = PM.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 24)))
    with torch.inference_mode():
        a = PM.forward(params, {"tokens": toks}, cfg)
        b = PM.forward(params, {"tokens": toks}, cfg, remat=remat,
                       unroll=unroll)
    assert torch.equal(a, b)
