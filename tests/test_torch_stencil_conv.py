"""The port's ``stencil_conv`` (K6) twin against the reference.

``repro_torch.kernels.stencil_conv.stencil_conv_torch`` against
``repro.kernels.ref.stencil_conv_ref`` bit for bit (both sum the taps
from 0 in ``di``-outer, ``dj``-inner order as separate multiplies and
adds), and against the Pallas kernel (``repro.kernels.stencil_conv``, in
interpret mode on the CPU) at ``rtol=1e-5, atol=1e-6 * max|ref|``: the
Pallas kernel's own sums differ from ``stencil_conv_ref`` by up to ~2e-7
of the output's magnitude.  Shapes and stencil sizes are those of
``tests/test_kernels.py`` plus a 3 x 5 stencil.

f16 and bf16 frames take the reference's two arithmetics:
``ops.stencil_conv(use_pallas=True)`` sums in f32 as the Pallas kernel
does and is held to it within one unit in the last place of the output
dtype (plus the f32 tolerance above); ``use_pallas=False`` sums in the
promoted dtype as ``stencil_conv_ref`` does and equals it bit for bit.

Shapes also straddle the card's output tiles (64 and 128 columns, 8 and
64 rows: outputs of tile - 1, tile and tile + 1) and take the functional
path's 360 x 640 (Fig. 5's binned frame) and 720 x 1280 frames.

For a CPU tensor the wrapper runs the twin (at f32 accumulation) and
counts a twin call; the CUDA kernels are held against that twin bit for
bit on the card, on the route that :func:`plan` picks from the shape,
dtype, alignment and SM count (tested here: the routes, the tiles, and
the refusal of a stencil whose tile does not fit in shared memory).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels import stencil_conv as ref_stencil

SHAPES = [(32, 48), (64, 96), (100, 140), (65, 65), (66, 66), (67, 67),
          (360, 640), (720, 1280)]
JAX_DTYPE = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
             torch.float32: jnp.float32}
STENCILS = [(2, 2), (3, 3), (5, 5), (3, 5)]


def _case(shape, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=k).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", STENCILS)
def test_twin_bit_equal_to_oracle(shape, k):
    from repro_torch.kernels.stencil_conv import stencil_conv_torch
    img, ker = _case(shape, k, seed=shape[0] + 10 * k[0] + k[1])
    want = np.asarray(ref.stencil_conv_ref(jnp.asarray(img),
                                           jnp.asarray(ker)))
    got = stencil_conv_torch(torch.from_numpy(img),
                             torch.from_numpy(ker)).numpy()
    assert got.shape == (shape[0] - k[0] + 1, shape[1] - k[1] + 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", STENCILS)
def test_twin_matches_reference_kernel(shape, k):
    from repro_torch.kernels.stencil_conv import stencil_conv_torch
    img, ker = _case(shape, k, seed=7 * shape[1] + k[0] * k[1])
    want = np.asarray(ref_stencil(jnp.asarray(img), jnp.asarray(ker)))
    got = stencil_conv_torch(torch.from_numpy(img),
                             torch.from_numpy(ker)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def test_twin_promotes_like_the_oracle():
    """An f16 image against f32 taps accumulates in f32 and returns f16,
    as ``stencil_conv_ref`` promotes."""
    from repro_torch.kernels.stencil_conv import stencil_conv_torch
    img, ker = _case((20, 24), (3, 3), seed=2)
    img16 = img.astype(np.float16)
    want = np.asarray(ref.stencil_conv_ref(jnp.asarray(img16),
                                           jnp.asarray(ker)))
    got = stencil_conv_torch(torch.from_numpy(img16), torch.from_numpy(ker))
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_runs_the_twin_and_checks_its_input():
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_conv as fn
    from repro_torch.kernels.stencil_conv import COUNTS, reset_counts
    img, ker = _case((12, 10), (3, 3), seed=1)
    reset_counts()
    out = fn(torch.from_numpy(img), torch.from_numpy(ker))
    none = {"kernel_launches": 0, "k3x3_launches": 0, "generic_launches": 0,
            "scalar_launches": 0}
    assert COUNTS == {**none, "twin_calls": 1}
    assert tuple(out.shape) == (10, 8)
    ops.stencil_conv(torch.from_numpy(img), torch.from_numpy(ker),
                     use_pallas=False)
    assert COUNTS == {**none, "twin_calls": 2}
    with pytest.raises(ValueError, match="2-D"):
        fn(torch.zeros(12), torch.zeros(3, 3))
    with pytest.raises(ValueError, match="no 'valid' output"):
        fn(torch.zeros(4, 4), torch.zeros(5, 3))
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros(8, 8, dtype=torch.float64), torch.zeros(3, 3))
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros(8, 8), torch.zeros(3, 3, dtype=torch.int32))
    assert COUNTS["twin_calls"] == 2


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=["float16", "bfloat16"])
@pytest.mark.parametrize("taps_f32", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("shape,k", [((64, 96), (3, 3)),
                                     ((100, 140), (3, 5)),
                                     ((9, 129), (3, 3)), ((10, 130), (3, 3)),
                                     ((11, 131), (3, 3)),
                                     ((360, 640), (3, 3)),
                                     ((720, 1280), (3, 3))])
def test_half_frames_follow_each_reference_route(shape, k, use_pallas,
                                                 taps_f32, dtype):
    from repro_torch.kernels import ops
    from repro_torch.testing import ulp
    from repro.kernels import ops as ref_ops
    img, ker = _case(shape, k, seed=shape[0] + k[1] + 3 * taps_f32)
    img_t = torch.from_numpy(img).to(dtype)
    ker_t = torch.from_numpy(ker).to(torch.float32 if taps_f32 else dtype)
    img_j = jnp.asarray(img_t.float().numpy()).astype(JAX_DTYPE[dtype])
    ker_j = jnp.asarray(ker_t.float().numpy()).astype(
        JAX_DTYPE[ker_t.dtype])
    got = ops.stencil_conv(img_t, ker_t, use_pallas=use_pallas)
    want = np.asarray(ref_ops.stencil_conv(img_j, ker_j,
                                           use_pallas=use_pallas)
                      .astype(jnp.float32))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if use_pallas:
        both = np.maximum(np.abs(got), np.abs(want))
        bound = ulp(torch.from_numpy(both), dtype).numpy() \
            + 1e-6 * float(np.abs(want).max())
        assert (np.abs(got - want) <= bound).all()
    else:
        np.testing.assert_array_equal(got, want)


def test_pallas_route_sums_in_f32():
    """An f16 frame against f16 taps: the wrapper's (Pallas) route sums in
    f32 and rounds once, the oracle route rounds every partial sum to
    f16; each is its own twin's arithmetic."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.stencil_conv import stencil_conv_torch
    img, ker = _case((40, 50), (5, 5), seed=11)
    img_t = torch.from_numpy(img).half()
    ker_t = torch.from_numpy(ker).half()
    f32 = stencil_conv_torch(img_t.float(), ker_t.float()).half()
    assert torch.equal(ops.stencil_conv(img_t, ker_t), f32)
    promoted = stencil_conv_torch(img_t, ker_t)
    assert torch.equal(ops.stencil_conv(img_t, ker_t, use_pallas=False),
                       promoted)
    assert not torch.equal(f32, promoted)


F32, F16, BF16 = torch.float32, torch.float16, torch.bfloat16


@pytest.mark.parametrize("h,w,k,dtype,aligned,want", [
    (360, 640, (3, 3), F32, True, "k3x3"),
    (720, 1280, (3, 3), BF16, True, "k3x3"),
    (720, 1280, (5, 5), F32, True, "generic"),
    (100, 140, (3, 5), F32, True, "generic"),
    (33, 72, (1, 1), F16, True, "generic"),
    (360, 640, (3, 3), F32, False, "scalar"),       # an offset view
    (360, 642, (3, 3), F32, True, "scalar"),        # rows of 2568 bytes
    (360, 644, (3, 3), F16, True, "scalar"),        # rows of 1288 bytes
    (360, 648, (3, 3), BF16, True, "k3x3"),         # rows of 1296 bytes
    (77, 45, (5, 5), F32, True, "scalar")])
def test_plan_picks_the_route(h, w, k, dtype, aligned, want):
    from repro_torch.kernels.stencil_conv import MAX_SMEM, plan
    p = plan(h, w, *k, dtype, aligned, 132)
    assert p.route == want
    assert p.tile_h == p.rows * (8 if want == "k3x3" else 4)
    assert 0 < p.smem <= MAX_SMEM


@pytest.mark.parametrize("dtype,tile_w", [(F32, 64), (F16, 128),
                                          (BF16, 128)])
def test_plan_sizes_the_tile_to_fill_the_sms(dtype, tile_w):
    """Fig. 5's binned 360 x 640 frame has a quarter of the outputs of a
    720 x 1280 one: it takes fewer rows a thread.  Each plan takes the
    most rows a thread whose blocks number three an SM (or one row); a
    card with one SM takes the largest tile."""
    from repro_torch.kernels.stencil_conv import ROW_CHOICES, plan
    small = plan(360, 640, 3, 3, dtype, True, 132)
    big = plan(720, 1280, 3, 3, dtype, True, 132)
    assert small.tile_w == big.tile_w == tile_w
    assert small.rows < big.rows
    for p, (oh, ow) in ((small, (358, 638)), (big, (718, 1278))):
        blocks = -(-oh // p.tile_h) * -(-ow // p.tile_w)
        assert blocks >= 3 * 132 or p.rows == 1
        if p.rows < ROW_CHOICES[0]:      # the next larger tile falls short
            taller = 2 * p.tile_h
            assert -(-oh // taller) * -(-ow // p.tile_w) < 3 * 132
    assert plan(720, 1280, 3, 3, dtype, True, 1).rows == ROW_CHOICES[0]
    tiny = plan(9, 64, 3, 3, dtype, True, 132)
    assert tiny.rows == 1 and tiny.tile_h == 8


@pytest.mark.parametrize("h,w,want", [
    (720, 1280, (64, 8)),       # the widest tile, rows 8, fills the card
    (400, 640, (64, 2)),        # the widest tile, fewer rows
    (200, 300, (32, 1)),        # only a narrower tile reaches 3 an SM
    (40, 64, (32, 1))])         # none does: the narrowest, one row
def test_plan_sizes_a_generic_tile_widest_first(h, w, want):
    """The generic route tries each width, widest first, and for each the
    rows 8, 4, 2, 1, until its blocks number three an SM; a frame too
    small for that at any tile takes the last: 32 columns, one row."""
    from repro_torch.kernels.stencil_conv import plan
    p = plan(h, w, 5, 5, F32, True, 132)
    assert p.route == "generic" and (p.tile_w, p.rows) == want
    blocks = -(-(h - 4) // p.tile_h) * -(-(w - 4) // p.tile_w)
    assert (blocks >= 3 * 132) == (h != 40)


def test_plan_refuses_a_stencil_too_large_for_shared_memory():
    """The generic route narrows its tile for a tall stencil (a 1000 x 1
    stencil's 32-column tile fits) and raises for one whose smallest tile
    does not fit in 227 KB."""
    from repro_torch.kernels.stencil_conv import MAX_SMEM, plan
    tall = plan(1100, 64, 1000, 1, F32, True, 132)
    assert tall.route == "generic" and tall.tile_w == 32
    assert tall.smem <= MAX_SMEM
    with pytest.raises(ValueError, match="shared-memory cap"):
        plan(3000, 3000, 2000, 2000, F32, True, 132)
    with pytest.raises(ValueError, match="shared-memory cap"):
        plan(3000, 3000, 2000, 2000, F16, False, 132)
