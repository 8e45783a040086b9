"""The port's functional simulator against the reference's, on the CPU.

``repro_torch.functional`` against ``repro.functional`` on the same
seeded 64 x 96 frames, the reference's kernels in interpret mode (as
``tests/test_runtime.py`` runs them):

* ``fig5_pipeline`` and ``edgaze_frontend`` bit-equal, through the
  kernels' route and the oracle route, including the Ed-Gaze roll (the
  same frame twice gives no events);
* ``simple_dnn`` at a hidden width of 40, weights carried across by
  ``params_from_reference``, held by the matmul rule applied through both
  layers: ``|port - ref| <= 1e-5 * ((|x| @ |w1|) @ |w2| + |h| @ |w2|)``;
* ``rhythmic_pixel_frontend``: the tile scores add in another order than
  XLA's, so the kept-tile mask is equal except for tiles whose score lies
  within rel 1e-5 of the cutoff, and every pixel of a tile both keep is
  equal;
* ``thermal_noise_sigma_volts`` exactly the reference's;
  ``with_thermal_noise`` reproducible from one generator seed, in the
  signal's dtype, with a sample std of ``out - signal`` within 3% of
  sigma over 1e6 samples (jax's and torch's random bits differ, so the
  distribution is what is compared).

On CPU tensors every kernel wrapper runs its twin and counts a twin call.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.functional import noise as ref_noise
from repro.functional import pipelines as ref_pipes
from repro.kernels import ref as ref_oracle

KERNELS = ("binning", "stencil_conv", "frame_event", "matmul")


def _frame(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _counts():
    return {name: dict(importlib.import_module(
        f"repro_torch.kernels.{name}").COUNTS) for name in KERNELS}


def _reset():
    for name in KERNELS:
        importlib.import_module(f"repro_torch.kernels.{name}").reset_counts()


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_fig5_pipeline_bit_equal(use_pallas, seed):
    from repro_torch.functional import fig5_pipeline
    img = _frame((64, 96), seed)
    want = np.asarray(ref_pipes.fig5_pipeline(jnp.asarray(img),
                                              use_pallas=use_pallas))
    got = fig5_pipeline(torch.from_numpy(img), use_pallas=use_pallas)
    assert tuple(got.shape) == (30, 46)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fig5_pipeline_step_edge():
    """The reference test's vertical step edge responds strongly."""
    from repro_torch.functional import fig5_pipeline
    step = torch.zeros(32, 32)
    step[:, 16:] = 1.0
    assert float(fig5_pipeline(step).max()) > 1.0


@pytest.mark.parametrize("use_pallas", [True, False])
def test_edgaze_frontend_bit_equal_and_roll(use_pallas):
    from repro_torch.functional import edgaze_frontend
    frames = [_frame((64, 96), seed) for seed in (2, 3)]
    prev_ref = jnp.zeros((32, 48), jnp.float32)
    prev = torch.zeros(32, 48)
    for cur in frames + frames[-1:]:
        want_ev, prev_ref = ref_pipes.edgaze_frontend(
            jnp.asarray(cur), prev_ref, threshold=0.05,
            use_pallas=use_pallas)
        events, prev = edgaze_frontend(torch.from_numpy(cur), prev,
                                       threshold=0.05, use_pallas=use_pallas)
        np.testing.assert_array_equal(events.numpy(), np.asarray(want_ev))
        np.testing.assert_array_equal(prev.numpy(), np.asarray(prev_ref))
    # the last frame repeats the one before: no events
    assert float(events.sum()) == 0.0


def _dnn_bound(x, w1, w2, h):
    x, w1, w2, h = (np.abs(np.asarray(t, np.float64)) for t in (x, w1, w2, h))
    return 1e-5 * ((x @ w1) @ w2 + np.maximum(h, 0) @ w2)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_simple_dnn_matches_reference(use_pallas):
    from repro_torch.functional import (edgaze_frontend, params_from_reference,
                                        simple_dnn)
    rng = np.random.default_rng(5)
    w1 = (rng.normal(size=(32 * 48, 40)) / 40).astype(np.float32)
    w2 = rng.normal(size=(40, 2)).astype(np.float32)
    cur = _frame((64, 96), 6)
    prev = _frame((32, 48), 7)
    events, _ = edgaze_frontend(torch.from_numpy(cur),
                                torch.from_numpy(prev))
    assert 0 < float(events.sum()) < events.numel()
    tw1, tw2 = params_from_reference(w1, w2, device="cpu")
    got = simple_dnn(events, tw1, tw2, use_pallas=use_pallas).numpy()
    x = events.numpy()
    want = np.asarray(ref_pipes.simple_dnn(jnp.asarray(x), jnp.asarray(w1),
                                           jnp.asarray(w2),
                                           use_pallas=use_pallas))
    hidden = x.reshape(1, -1).astype(np.float64) @ w1
    assert got.shape == want.shape == (1, 2)
    assert (np.abs(got - want) <= _dnn_bound(x.reshape(1, -1), w1, w2,
                                             hidden)).all()


def _tile_keep(out, image, tile):
    th, tw = (image.shape[0] + 2) // tile, (image.shape[1] + 2) // tile
    o = out[: th * tile, : tw * tile].reshape(th, tile, tw, tile)
    return (o != 0).any(axis=(1, 3))


@pytest.mark.parametrize("tile,keep_fraction,periodic", [
    (16, 0.5, False), (8, 0.25, False), (16, 0.5, True)])
def test_rhythmic_pixel_frontend_matches_reference(tile, keep_fraction,
                                                   periodic):
    from repro_torch.functional import rhythmic_pixel_frontend
    img = _frame((64, 96), 9) + 0.01          # no zero pixels
    if periodic:                              # interior tiles tie exactly
        img = np.tile(img[:16, :16], (4, 6))
    want = np.asarray(ref_pipes.rhythmic_pixel_frontend(
        jnp.asarray(img), tile=tile, keep_fraction=keep_fraction))
    got = rhythmic_pixel_frontend(torch.from_numpy(img), tile=tile,
                                  keep_fraction=keep_fraction).numpy()
    assert got.shape == want.shape == img.shape
    # the cutoff from f64 scores of the reference's own activity map
    sob = jnp.asarray(ref_pipes.SOBEL_X)
    gx = np.asarray(ref_oracle.stencil_conv_ref(jnp.asarray(img), sob))
    gy = np.asarray(ref_oracle.stencil_conv_ref(jnp.asarray(img), sob.T))
    act = np.pad(np.abs(gx) + np.abs(gy), 1).astype(np.float64)
    th, tw = act.shape[0] // tile, act.shape[1] // tile
    score = act[: th * tile, : tw * tile].reshape(th, tile, tw, tile).sum(
        axis=(1, 3))
    k = max(int(score.size * keep_fraction), 1)
    cutoff = np.sort(score.reshape(-1))[-k]
    keep_got, keep_want = _tile_keep(got, img, tile), _tile_keep(want, img,
                                                                 tile)
    assert keep_got.sum() >= k
    differ = keep_got != keep_want
    assert (np.abs(score[differ] - cutoff) <= 1e-5 * cutoff).all()
    both = np.repeat(np.repeat(keep_got & keep_want, tile, 0), tile, 1)
    region = (slice(0, th * tile), slice(0, tw * tile))
    np.testing.assert_array_equal(got[region][both], want[region][both])
    np.testing.assert_array_equal(got[region][both], img[region][both])
    assert not got[region][~np.repeat(np.repeat(keep_got, tile, 0), tile,
                                      1)].any()


@pytest.mark.parametrize("capacitance", [1e-15, 10e-15, 2.5e-13])
def test_thermal_noise_sigma_is_the_reference(capacitance):
    from repro_torch.functional import thermal_noise_sigma_volts
    assert thermal_noise_sigma_volts(capacitance) == \
        ref_noise.thermal_noise_sigma_volts(capacitance)
    assert thermal_noise_sigma_volts(capacitance, 350.0) == \
        ref_noise.thermal_noise_sigma_volts(capacitance, 350.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_with_thermal_noise_distribution(dtype):
    from repro_torch.functional import (thermal_noise_sigma_volts,
                                        with_thermal_noise)
    cap = 1e-15 if dtype == torch.float16 else 10e-15
    signal = torch.full((1000, 1000), 0.5, dtype=dtype)
    out = with_thermal_noise(torch.Generator().manual_seed(11), signal, cap,
                             v_swing=0.8)
    again = with_thermal_noise(torch.Generator().manual_seed(11), signal,
                               cap, v_swing=0.8)
    assert out.dtype == dtype and torch.equal(out, again)
    sigma = thermal_noise_sigma_volts(cap) / 0.8
    std = float((out.double() - signal.double()).std())
    assert abs(std - sigma) <= 0.03 * sigma
    # the reference's noise has the same spread (its own random bits)
    ref_out = ref_noise.with_thermal_noise(
        jax.random.PRNGKey(11), jnp.full((1000, 1000), 0.5, jnp.float32),
        cap, v_swing=0.8)
    ref_std = float(np.std(np.asarray(ref_out, np.float64) - 0.5))
    assert abs(ref_std - std) <= 0.03 * sigma


def test_params_from_reference():
    from repro_torch.functional import params_from_reference
    rng = np.random.default_rng(1)
    w1 = rng.normal(size=(6, 4))              # f64 in, f32 out
    w2 = np.asfortranarray(rng.normal(size=(4, 2)).astype(np.float32))
    tw1, tw2 = params_from_reference(w1, jnp.asarray(w2), device="cpu")
    for t, w in ((tw1, w1), (tw2, w2)):
        assert t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), w.astype(np.float32))


def test_params_default_device_without_cuda_raises(monkeypatch):
    from repro_torch.functional import params_from_reference
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference(np.zeros((2, 2)), np.zeros((2, 1)))


def test_pipelines_on_cpu_run_only_twins():
    from repro_torch.functional import (edgaze_frontend, fig5_pipeline,
                                        params_from_reference,
                                        rhythmic_pixel_frontend, simple_dnn)
    img = torch.from_numpy(_frame((64, 96), 12))
    w1, w2 = params_from_reference(np.ones((32 * 48, 3)), np.ones((3, 2)),
                                   device="cpu")
    _reset()
    fig5_pipeline(img)
    events, _ = edgaze_frontend(img, torch.zeros(32, 48))
    rhythmic_pixel_frontend(img)
    simple_dnn(events, w1, w2)
    counts = _counts()
    assert all(c["kernel_launches"] == 0 for c in counts.values()), counts
    assert {name: c["twin_calls"] for name, c in counts.items()} == {
        "binning": 2, "stencil_conv": 4, "frame_event": 1, "matmul": 2}
