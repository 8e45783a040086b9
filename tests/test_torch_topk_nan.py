"""F5: every top-k of the port ranks as the reference's ``lax.top_k(-x)``.

The reference ranks a chunk's candidates and the running top-k by
``jax.lax.top_k(-x)``, which orders ``-x`` in IEEE total order.  So in
ascending ``x`` a NaN with its sign bit set (what ``0/0`` gives on x86)
comes before ``-inf``, ``-0`` before ``+0``, and a positive NaN after
``+inf``; equal values keep the lowest position.  ``torch.sort`` puts
every NaN last and ``-0`` level with ``+0``.  These tests hold the port
to the reference on such values, on the CPU:

* the block twin of K1 against ``fused_sweep_block_xla``, through a
  synthetic ``compute`` both take;
* ``_merge_candidates`` against the reference's, over several merges;
* the staged chunk (decode, evaluator, block stats, candidates) and its
  merge against the reference's ``_banked_step``;
* whole ``explore(engine="fused"|"staged")`` runs whose evaluator output
  is patched to NaN of either sign (or to ``+-0``) at the same design
  points in both packages, and campaign shards of such runs merged by
  each package's ``merge_stream_results``;
* a NumPy emulation of K1's reduction (warps, a CTA's passes, the
  cluster; total-order keys and a pad pair above every real pair)
  against the twin's order.

Every case holds a sign-bit NaN or a ``+0`` placed before a ``-0``, so
each one fails where the port sorted with ``torch.sort``.
"""
import numpy as np
import pytest
import torch

with np.errstate(invalid="ignore"):
    NEG_NAN = (np.zeros(1, np.float32) / np.zeros(1, np.float32))[0]
POS_NAN = np.float32(np.nan)
assert np.float32(NEG_NAN).view(np.uint32) == 0xFFC00000
assert POS_NAN.view(np.uint32) == 0x7FC00000

#: values the cases draw from: NaN of both signs, +-inf, +-0 and ties
POOL = np.array([NEG_NAN, POS_NAN, -np.inf, np.inf, -0.0, 0.0, 1.0, 2.0,
                 2.0, -3.0], np.float32)

GRIDS = {"variant": ["2d_in", "3d_in"],
         "frame_rate": [15.0, 30.0, 60.0],
         "sys_rows": [8.0, 32.0],
         "vdd_scale": [0.9, 1.0, 1.1]}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _draw(rng, n: int) -> np.ndarray:
    """``n`` values from POOL, with a sign-bit NaN and a ``+0`` placed
    before a ``-0``."""
    v = rng.choice(POOL, n)
    v[n // 3] = NEG_NAN
    v[0], v[n - 1] = 0.0, -0.0
    return v


# ---------------------------------------------------------------------------
# the block twin (K1's plain version)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk,bp,kk,low,limit", [
    (32, 8, 3, 0, 32), (32, 8, 8, 0, 32), (24, 6, 10, 0, 24),
    (40, 16, 5, 3, 37), (17, 17, 17, 0, 17)])
def test_block_twin_orders_as_reference(chunk, bp, kk, low, limit):
    import jax.numpy as jnp
    from repro.kernels.fused_sweep_xla import fused_sweep_block_xla
    from repro_torch.kernels.fused_sweep import fused_sweep_block_torch

    rng = np.random.default_rng(chunk * 100 + bp * 10 + kk)
    metric = _draw(rng, chunk)
    feas = rng.random(chunk) < 0.8
    table2 = np.arange(chunk, dtype=np.float32).reshape(1, chunk)
    kw = dict(metric="total_j", axis_names=("frame_rate",), shape=(chunk,),
              n_var=chunk, total=chunk, chunk=chunk, lmax=chunk,
              block_points=bp, kk=kk)

    def ref_compute(_row, vals):
        i = vals["frame_rate"].astype(jnp.int32)
        return {"feasible": jnp.asarray(feas)[i],
                "total_j": jnp.asarray(metric)[i]}

    def our_compute(_row, vals):
        i = vals["frame_rate"].long()
        return {"feasible": torch.from_numpy(feas)[i],
                "total_j": torch.from_numpy(metric)[i]}

    want = fused_sweep_block_xla(jnp.asarray(table2), jnp.zeros((1,)), 0,
                                 low, limit, compute=ref_compute,
                                 idx_dtype=jnp.int32, **kw)
    got = fused_sweep_block_torch(torch.from_numpy(table2), torch.zeros(1),
                                  0, low, limit, compute=our_compute,
                                  idx_dtype=torch.int32, **kw)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


# ---------------------------------------------------------------------------
# _merge_candidates: the running top-k and per-variant summaries
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,n_cand,seed", [(4, 4, 0), (6, 3, 1), (3, 8, 2)])
def test_merge_candidates_matches_reference(k, n_cand, seed):
    import jax.numpy as jnp
    from repro.core import shard_sweep as ref
    from repro_torch.core import shard_sweep as ours
    from repro_torch.core.batch import OUT_KEYS

    rng = np.random.default_rng(seed)
    n_variants = 3
    ours_state = ours._init_banked_state(k, n_variants, torch.int32, "cpu",
                                         with_out=True)
    ref_state = {key: jnp.asarray(val.numpy())
                 for key, val in ours_state.items()}
    flat = 0
    for step in range(6):
        v = int(rng.integers(n_variants))
        cand_v = _draw(rng, n_cand)
        cand_i = np.arange(flat, flat + n_cand, dtype=np.int32)
        rng.shuffle(cand_i)
        flat += n_cand
        out = rng.random((n_cand, len(OUT_KEYS))).astype(np.float32)
        mins = np.float32(rng.choice(POOL))
        amin = np.int32(rng.integers(flat))
        sums = np.float32(rng.choice(POOL))
        counts = np.float32(rng.integers(0, 4))
        ref_state = ref._merge_candidates(
            dict(cand_v=jnp.asarray(cand_v), cand_i=jnp.asarray(cand_i),
                 cand_out=jnp.asarray(out),
                 mins=jnp.asarray([mins]), amin_i=jnp.asarray([amin]),
                 sums=jnp.asarray([sums]), counts=jnp.asarray([counts])),
            v, ref_state, k, True)
        ours._merge_candidates(
            dict(cand_v=torch.from_numpy(cand_v),
                 cand_i=torch.from_numpy(cand_i),
                 cand_out=torch.from_numpy(out),
                 mins=torch.tensor(mins), amin_i=torch.tensor(amin),
                 sums=torch.tensor(sums), counts=torch.tensor(counts)),
            v, ours_state, k)
        _assert_state_equal(ours_state, ref_state, f"step {step}")


def _assert_values_equal(got, want, rel, msg):
    """Bit for bit where ``rel`` is 0; else the same NaN, infinity and
    sign pattern and finite values within ``rel`` (the two packages'
    evaluators differ in the last ulp on natural points, ROADMAP R2)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not rel:
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)
        return
    for pick in (np.isnan, np.isinf, np.signbit):
        np.testing.assert_array_equal(pick(got), pick(want), err_msg=msg)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rel, err_msg=msg)


def _assert_state_equal(ours, ref, msg="", rel=0.0):
    """Top-k values bit for bit (NaN sign and payload included) and their
    indices exactly; winners' rows and per-variant sums and minima to
    ``rel``, a NaN matching a NaN (a NaN's sign in ``metric_min`` orders
    nothing: the merge compares it as a Python float); counts and argmins
    exactly."""
    _assert_values_equal(ours["topk_v"].numpy(), ref["topk_v"], 0.0, msg)
    for key in ("topk_i", "n_feasible", "argmin"):
        np.testing.assert_array_equal(ours[key].numpy(),
                                      np.asarray(ref[key]),
                                      err_msg=f"{msg} {key}")
    for key in ("topk_out", "metric_sum", "metric_min"):
        if key == "metric_min":
            np.testing.assert_array_equal(
                np.isnan(ours[key].numpy()), np.isnan(np.asarray(ref[key])),
                err_msg=f"{msg} {key}")
            keep = ~np.isnan(np.asarray(ref[key]))
            _assert_values_equal(ours[key].numpy()[keep],
                                 np.asarray(ref[key])[keep], rel,
                                 f"{msg} {key}")
        elif key in ref:
            _assert_values_equal(ours[key].numpy(), ref[key], rel,
                                 f"{msg} {key}")


# ---------------------------------------------------------------------------
# patched evaluators: the same special values at the same design points
# ---------------------------------------------------------------------------
def _special(pt, value, cases):
    """``value`` with ``cases[(frame_rate, sys_rows)]`` written in where
    the point has those axis values; works on numpy, jax and torch."""
    get = pt.get if isinstance(pt, dict) else (lambda n: getattr(pt, n))
    fr, rows = get("frame_rate"), get("sys_rows")
    out = value
    for (f, r), x in cases.items():
        cond = (fr == f) & (rows == r)
        if isinstance(value, torch.Tensor):
            out = torch.where(cond, torch.tensor(x, dtype=torch.float32,
                                                  device=value.device), out)
        elif isinstance(value, np.ndarray):
            out = np.where(cond, np.float32(x), out).astype(np.float32)
        else:
            import jax.numpy as jnp
            out = jnp.where(cond, jnp.asarray(np.float32(x)), out)
    return out


def _patch_compute(build, cases):
    def patched(*args, **kwargs):
        compute = build(*args, **kwargs)

        def wrapped(row, vals):
            out = dict(compute(row, vals))
            out["total_j"] = _special(vals, out["total_j"], cases)
            return out
        return wrapped
    return patched


def _patch_banked(build, cases):
    def patched(*args, **kwargs):
        fn, fn_uniform = build(*args, **kwargs)

        def uniform(bank, v, points):
            out = dict(fn_uniform(bank, v, points))
            out["total_j"] = _special(points, out["total_j"], cases)
            return out
        return fn, uniform
    return patched


def _patch_eval_bank(fn, cases):
    def patched(bank, vids, points):
        out = dict(fn(bank, vids, points))
        out["total_j"] = _special(points, np.asarray(out["total_j"]), cases)
        return out
    return patched


@pytest.fixture()
def patch_both(monkeypatch):
    """Patch the evaluators of both packages to write ``cases`` into the
    metric; the reference's executable cache and the port's step cache
    are cleared around the patch so no patched executable or step
    outlives the test."""
    from repro.core import shard_sweep as ref
    from repro_torch.core import shard_sweep as ours

    def apply(cases):
        ref.stream_cache_clear()
        ours.stream_cache_clear()
        monkeypatch.setattr(ref, "build_coeff_compute",
                            _patch_compute(ref.build_coeff_compute, cases))
        monkeypatch.setattr(ref, "build_banked_eval",
                            _patch_banked(ref.build_banked_eval, cases))
        monkeypatch.setattr(ref, "evaluate_bank",
                            _patch_eval_bank(ref.evaluate_bank, cases))
        monkeypatch.setattr(ours, "build_coeff_compute",
                            _patch_compute(ours.build_coeff_compute, cases))
        monkeypatch.setattr(ours, "build_banked_eval",
                            _patch_banked(ours.build_banked_eval, cases))
    yield apply
    ref.stream_cache_clear()
    ours.stream_cache_clear()


def _summaries_equal(a, b):
    assert list(a) == list(b)
    for label, sa in a.items():
        sb = b[label]
        for key in ("n", "n_feasible", "argmin_index", "argmin_point"):
            assert sa[key] == sb[key], (label, key, sa[key], sb[key])
        for key in ("metric_min", "metric_mean"):
            x, y = sa[key], sb[key]
            if np.isnan(x) or np.isnan(y):
                assert np.isnan(x) and np.isnan(y), (label, key, x, y)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-6,
                                           err_msg=f"{label}.{key}")


#: (frame_rate, sys_rows) -> the metric written at those points
CASES = {
    "sign_bit_nan": {(30.0, 32.0): NEG_NAN},
    "both_nans": {(30.0, 32.0): POS_NAN, (15.0, 8.0): NEG_NAN,
                  (60.0, 8.0): POS_NAN},
    "signed_zeros": {(15.0, 8.0): 0.0, (60.0, 32.0): -0.0},
}


@pytest.mark.parametrize("engine", ["fused", "staged"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_explore_with_special_metrics_matches_reference(engine, case,
                                                        patch_both):
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro_torch.explore import DesignSpace, explore

    cases = CASES[case]
    space = DesignSpace(["edgaze"], GRIDS)
    if case == "signed_zeros":
        # a +0 point precedes a -0 point in flat order, so a sort that
        # takes them level ranks the +0 first and the reference does not
        def flat(fr_rows):
            return [i for i in range(space.n_points)
                    if (space.decode(i)["frame_rate"],
                        space.decode(i)["sys_rows"]) == fr_rows]
        assert min(flat((15.0, 8.0))) < max(flat((60.0, 32.0)))
    patch_both(cases)
    kw = dict(k=6, engine=engine, chunk_size=4, block_points=4)
    if engine == "fused":
        kw["superchunk"] = 16
    want = ref_explore(RefSpace(["edgaze"], GRIDS),
                       **(dict(kw, backend="xla") if engine == "fused"
                          else kw))
    got = explore(space, device="cpu", **kw)
    assert got.n_points == want.n_points
    assert got.n_feasible == want.n_feasible
    assert ([(r["variant"], r["index"]) for r in got.topk]
            == [(r["variant"], r["index"]) for r in want.topk])
    np.testing.assert_array_equal(_bits([r["total_j"] for r in got.topk]),
                                  _bits([r["total_j"] for r in want.topk]))
    _summaries_equal(got.summaries, want.summaries)
    if "nan" in case:
        assert want.topk == [], "a sign-bit NaN ranks first: no finite rows"


@pytest.mark.parametrize("case", ["sign_bit_nan", "both_nans"])
def test_merged_nan_shards_match_reference(case, patch_both):
    """Campaign shards merged by ``merge_stream_results``: a shard whose
    first candidate is a sign-bit NaN keeps no rows, so the merge ranks
    only the other shards' rows, in both packages alike."""
    from repro.campaign import merge_stream_results as ref_merge
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro_torch.campaign import merge_stream_results
    from repro_torch.explore import DesignSpace, explore

    patch_both(CASES[case])
    ours_space, ref_space = DesignSpace(["edgaze"], GRIDS), RefSpace(
        ["edgaze"], GRIDS)
    kw = dict(k=6, engine="fused", chunk_size=4, block_points=4,
              superchunk=16)
    bounds = (0, 7, 14, 21, 28, 36)
    ours = [explore(ours_space, device="cpu", index_range=r, **kw)
            .stream_result for r in zip(bounds, bounds[1:])]
    want = [ref_explore(ref_space, backend="xla", index_range=r, **kw)
            .stream_result for r in zip(bounds, bounds[1:])]
    assert [len(s.topk) for s in ours] == [len(s.topk) for s in want]
    assert any(not s.topk for s in want), "no shard led by a sign-bit NaN"
    got, ref = merge_stream_results(ours, k=6), ref_merge(want, k=6)
    assert ([(r["variant"], r["index"]) for r in got.topk]
            == [(r["variant"], r["index"]) for r in ref.topk])
    assert got.topk, "the other shards' rows survive the merge"
    np.testing.assert_allclose([r["total_j"] for r in got.topk],
                               [r["total_j"] for r in ref.topk], rtol=1e-6)
    _summaries_equal(got.summaries, ref.summaries)


def test_staged_chunk_candidates_match_reference(patch_both):
    """One staged chunk (decode, the banked evaluator, block stats, the
    chunk's candidates with their output rows) merged into a fresh
    state, against the reference's ``_banked_step``."""
    import jax
    import jax.numpy as jnp
    from repro.core import shard_sweep as ref
    from repro.launch.mesh import make_batch_mesh
    from repro_torch.core import shard_sweep as ours

    patch_both(CASES["both_nans"] | {(30.0, 8.0): 0.0, (60.0, 32.0): -0.0})
    k, chunk, bp = 5, 16, 4
    algos = ["edgaze"]
    ref_prep = ref._prepare_stream(algos, GRIDS)
    our_prep = ours._prepare_stream(algos, GRIDS, device="cpu")
    shape = tuple(our_prep.vgrids[0].shape)
    step, out_keys = ref._banked_step(ref_prep.bank, make_batch_mesh(1),
                                      "total_j", k, chunk, bp, shape,
                                      ref_prep.n_var, jnp.int32)
    step = jax.jit(step)
    _, eval_uniform = ours.build_banked_eval(our_prep.bank.dims)
    n_var = our_prep.n_var
    for start, limit in ((0, n_var), (16, n_var), (n_var, 2 * n_var)):
        state0 = ref._init_banked_state(k, len(out_keys),
                                        ref_prep.n_variants, jnp.int32)
        want, _ = step(jnp.int32(start), jnp.int32(limit), ref_prep.tables,
                       ref_prep.bank.arrays, state0)
        got = ours._init_banked_state(k, our_prep.n_variants, torch.int32,
                                      "cpu", with_out=True)
        ours._merge_candidates(ours._staged_chunk(
            our_prep, eval_uniform, start, limit, chunk=chunk, bp=bp, kk=k,
            metric="total_j", idx_dtype=torch.int32, variant=start // n_var,
            replica=(our_prep.table2, our_prep.bank)),
            start // n_var, got, k)
        _assert_state_equal(got, want, f"chunk at {start}", rel=1e-6)


# ---------------------------------------------------------------------------
# K1's reduction, emulated on total-order keys, against the twin's order
# ---------------------------------------------------------------------------
_NONE = np.uint64(2 ** 64 - 1)        # the kernel's pad pair, above all


def _keys(v: np.ndarray) -> np.ndarray:
    b = _bits(v)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint64)


def _least(pairs: np.ndarray, n: int) -> np.ndarray:
    out = np.full(n, _NONE, np.uint64)
    top = np.sort(pairs)[:n]
    out[:top.size] = top
    return out


def _kernel_reduce(masked: np.ndarray, p, kk: int):
    """K1's reduction of one ``(bp,)`` block under plan ``p`` on
    ``(key << 32 | position)`` pairs: each rank's points in passes of its
    tile, each warp's ``kw`` least, the CTA's ``kc`` least of its warps'
    lists and its running list, the block's ``kout`` least of its CTAs'
    lists; a pad pair is written as ``(+inf, 0)``."""
    from repro_torch.kernels.fused_sweep import THREADS
    bp = masked.shape[0]
    pairs = (_keys(masked) << np.uint64(32)) | np.arange(bp, dtype=np.uint64)
    ctas = []
    for r in range(p.cluster):
        q0 = r * p.rank_points
        n_here = max(0, min(bp - q0, p.rank_points))
        run = _least(np.zeros(0, np.uint64), p.kc)
        for p0 in range(0, n_here, p.tile):
            n_pass = min(p.tile, n_here - p0)
            lists = [run]
            for w in range(THREADS // 32):
                qr = (np.arange(p.ppt)[:, None] * THREADS + w * 32
                      + np.arange(32)[None, :]).ravel()
                lists.append(_least(pairs[q0 + p0 + qr[qr < n_pass]], p.kw))
            run = _least(np.concatenate(lists), p.kc)
        ctas.append(run)
    best = _least(np.concatenate(ctas), p.kout)
    none = best == _NONE
    k = (best >> np.uint64(32)).astype(np.uint32)
    val = np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32)
    val = np.where(none, np.float32(np.inf).view(np.uint32), val)
    pos = np.where(none, 0, best & np.uint64(0xFFFFFFFF)).astype(np.int64)
    pad = kk - p.kout
    return (np.concatenate([val, np.full(pad, 0x7F800000, np.uint32)]),
            np.concatenate([pos, np.zeros(pad, np.int64)]))


@pytest.mark.parametrize("layout", ["mixed", "mostly_positive_nan"])
@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("bp,kk", [(4096, 3), (1024, 32), (40, 64),
                                   (3000, 8)])
def test_kernel_reduction_emulation_equals_twin_order(cluster, bp, kk,
                                                      layout):
    """NaN of both signs, +-inf, +-0 and ties, one CTA's slice all masked;
    or a block all positive NaN but three points, so positive NaNs (above
    the +inf of masked points, where a pad pair at +inf would hide them)
    reach the candidates."""
    from repro_torch.kernels.fused_sweep import make_plan, sort_total
    p = make_plan(bp, kk, bp, cluster)
    rng = np.random.default_rng(bp + kk + cluster)
    if layout == "mixed":
        masked = _draw(rng, bp)
        if p.cluster > 1:
            masked[p.rank_points: 2 * p.rank_points] = np.inf
    else:
        masked = np.full(bp, POS_NAN)
        masked[[0, bp // 3, bp - 1]] = [0.0, NEG_NAN, -0.0]
    got_v, got_q = _kernel_reduce(masked, p, kk)
    want_v, want_q = sort_total(torch.from_numpy(masked))
    want_v, want_q = _bits(want_v[:kk].numpy()), want_q[:kk].numpy()
    if kk > bp:
        want_v = np.concatenate([want_v, np.full(kk - bp, 0x7F800000,
                                                 np.uint32)])
        want_q = np.concatenate([want_q, np.zeros(kk - bp, np.int64)])
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_q, want_q)
