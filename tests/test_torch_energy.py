"""The port's energy model (``repro_torch.energy``) against the
reference's (``repro.energy``), and the counts of a traced torch step
against XLA's.

* ``hlo.collective_bytes`` and ``_shape_bytes`` equal the reference's on
  its strings; ``roofline_terms(...).as_dict()`` and
  ``tpu_energy_report`` are bit-equal under ``V5E`` on hypothesis-drawn
  inputs; ``model_flops`` is equal for the ten architectures in all three
  kinds; ``tests/test_properties.py``'s three energy tests, mirrored.
  ``H100`` holds the card's published figures, and ``roofline_fraction``
  divides by the ``hw`` the terms were built with (the reference's
  ``V5E`` whatever ``hw``: R8).
* The per-device rule on a fake ``(2, 2)`` and ``(4, 2)`` mesh (a fake
  process group of 512 ranks, ``FakeTensorMode``): a sharded matmul counts
  this rank's FLOPs under Shard, Partial and Replicate outputs; on plain
  tensors the product count equals ``FlopCounterMode``'s;
  ``distributed/ops.py``'s shard-local ``einsum`` and DTensor's own
  ``torch.einsum`` count the same.
* The collective counter: Shard -> Replicate is an all-gather at 1x its
  result, Partial -> Replicate an all-reduce at 2x; the int8
  ``cross_pod_grad_reduce``'s in-place ``dist.all_reduce`` is counted; a
  ``(1, 1)`` mesh counts 0.
* FLOPs against XLA: the port's ``flops_dev`` on a ``(1, 1)`` mesh
  against the reference's ``_compile(..., unroll=True)`` on a one-device
  ``jax.sharding.Mesh`` (``reduced(cfg, n_layers=2, d_model=256)``, B =
  2, S = 256), dense, MoE, SSM and hybrid, each in train, prefill and
  decode.  The reference is compiled in subprocesses with XLA's
  ``fusion`` pass off: on the CPU, fusion copies cheap producers into
  every consumer and the cost analysis counts each copy (the reference's
  own SSM scan alone counts 36.6 FLOPs an element fused).  Dense, MoE and
  hybrid hold within rel 3%; the SSM within 10% (measured 1.05-1.08: the
  port's Hillis-Steele scan does ``n log n`` combines where
  ``lax.associative_scan`` does ~2n), and within 3% with the reference's
  scan swapped, inside the subprocess only, for the port's algorithm
  written in ``jnp``.  The port's ``flops_dev`` is the unfused count.
  Against the count the reference's dry run records (fusion on) each
  family stays in a stated band: within 3% of 1, the SSM's train and
  prefill at 0.78-0.84 and 0.82-0.88 (measured 0.809 and 0.853).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as r_get_config
from repro.energy import hlo as r_hlo
from repro.energy import roofline as r_roof
from repro.energy import tpu_energy as r_energy
from repro_torch.configs import get_config, reduced
from repro_torch.energy import (H100, V5E, CollectiveCounter, StepTrace,
                                collective_bytes, model_flops,
                                roofline_terms, tpu_energy_report)
from repro_torch.energy import hlo as p_hlo
from repro_torch.launch import dryrun as PD
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

settings.register_profile("torch_energy", max_examples=50, deadline=None)

SRC = Path(__file__).resolve().parents[1] / "src"
HLO = """
  %ar = f32[128,8]{1,0} all-reduce(%x), replica_groups={}
  %ag = bf16[64]{0} all-gather(%y), dimensions={0}
  %cp = f32[4]{0} collective-permute(%z)
  %ags = (bf16[16,512,320]{2,1,0}, s32[]) all-gather-start(%w)
  %agd = bf16[16,512,320]{2,1,0} all-gather-done(%ags)
  ROOT %rs = (f32[8,4]{1,0}, f32[8,4]{1,0}) reduce-scatter(%a, %b)
  %a2a = s8[2,3]{1,0} all-to-all(%q)
"""


# ---------------------------------------------------------------------------
# Copies of the reference's jax-free modules
# ---------------------------------------------------------------------------
def test_collective_bytes_equal_the_reference():
    assert p_hlo.collective_bytes(HLO) == r_hlo.collective_bytes(HLO)
    assert p_hlo.parse_collectives(HLO) == r_hlo.parse_collectives(HLO)
    for s in ("f32[3,4]{1,0}", "(bf16[2], s32[])", "pred[7]", "u4[8]"):
        assert p_hlo._shape_bytes(s) == r_hlo._shape_bytes(s)


@settings(settings.get_profile("torch_energy"))
@given(f=st.floats(1e6, 1e15), b=st.floats(1e3, 1e12),
       c=st.floats(0, 1e12), chips=st.integers(1, 4096),
       mf=st.floats(1e6, 1e18), dcn=st.floats(0, 1e12))
def test_roofline_and_energy_bit_equal_under_v5e(f, b, c, chips, mf, dcn):
    mine = roofline_terms(f, b, c, chips, mf)
    ref = r_roof.roofline_terms(f, b, c, chips, mf)
    assert mine.as_dict() == ref.as_dict()
    assert mine.hw is V5E
    assert tpu_energy_report(f, b, c, chips, dcn) == \
        r_energy.tpu_energy_report(f, b, c, chips, dcn)
    # the same inputs on H100: the terms take its rates, the energies the
    # reference's per-access constants
    h = roofline_terms(f, b, c, chips, mf, hw=H100)
    assert h.t_compute == f / 989e12 and h.t_memory == b / 3.35e12
    assert h.roofline_fraction == pytest.approx(
        mf / (h.bound_time * chips * 989e12), rel=1e-12)
    assert tpu_energy_report(f, b, c, chips, dcn, hw=H100) == \
        tpu_energy_report(f, b, c, chips, dcn)


def test_h100_constants_and_r8():
    assert (H100.peak_flops, H100.hbm_bw, H100.ici_bw, H100.hbm_bytes) == \
        (989e12, 3.35e12, 450e9, 80e9)
    for k in ("pj_per_flop", "pj_per_hbm_byte", "pj_per_ici_byte",
              "pj_per_dcn_byte"):
        assert getattr(H100, k) == getattr(r_roof.V5E, k)
    # R8: the reference divides by V5E's peak whatever hw it was given
    ref = r_roof.roofline_terms(1e15, 1e9, 0.0, 8, 5e14,
                                hw=r_roof.HW(peak_flops=989e12))
    mine = roofline_terms(1e15, 1e9, 0.0, 8, 5e14, hw=H100)
    assert ref.roofline_fraction == pytest.approx(
        5e14 / (ref.bound_time * 8 * 197e12), rel=1e-12)
    assert mine.roofline_fraction == pytest.approx(
        5e14 / (mine.bound_time * 8 * 989e12), rel=1e-12)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_the_reference(kind):
    for arch in ARCH_IDS:
        for b, s in ((1, 1), (256, 4096), (32, 32768)):
            assert model_flops(get_config(arch), kind, b, s) == \
                r_roof.model_flops(r_get_config(arch), kind, b, s)
    with pytest.raises(ValueError):
        model_flops(get_config("olmo_1b"), "serve", 1, 1)


# tests/test_properties.py:84-119, mirrored
@settings(settings.get_profile("torch_energy"))
@given(f=st.floats(1e6, 1e15), b=st.floats(1e3, 1e12),
       c=st.floats(0, 1e12), chips=st.integers(1, 4096),
       mf=st.floats(1e6, 1e18))
def test_roofline_terms_invariants(f, b, c, chips, mf):
    for hw in (V5E, H100):
        t = roofline_terms(f, b, c, chips, mf, hw=hw)
        assert t.bound_time >= max(t.t_compute, t.t_memory,
                                   t.t_collective) - 1e-12
        assert t.dominant in ("compute", "memory", "collective")
        assert t.flops_global == pytest.approx(f * chips)
        if t.dominant == "compute":
            assert t.roofline_fraction <= \
                t.useful_compute_ratio * (1 + 1e-9)


@settings(settings.get_profile("torch_energy"))
@given(dims=st.lists(st.integers(1, 64), min_size=1, max_size=4),
       dtype=st.sampled_from(["f32", "bf16", "s32", "u8"]))
def test_shape_bytes(dims, dtype):
    nbytes = {"f32": 4, "bf16": 2, "s32": 4, "u8": 1}[dtype]
    s = f"{dtype}[{','.join(map(str, dims))}]{{0}}"
    assert p_hlo._shape_bytes(s) == nbytes * int(np.prod(dims))


def test_collective_parse_weighting():
    hlo = """
  %ar = f32[128,8]{1,0} all-reduce(%x), replica_groups={}
  %ag = bf16[64]{0} all-gather(%y), dimensions={0}
  %cp = f32[4]{0} collective-permute(%z)
"""
    weighted, per_op = collective_bytes(hlo)
    assert per_op["all-reduce"] == 128 * 8 * 4
    assert per_op["all-gather"] == 64 * 2
    assert per_op["collective-permute"] == 16
    assert weighted == 2 * 4096 + 128 + 16


# ---------------------------------------------------------------------------
# The per-device rule and the collective counter, on a fake mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fake_pg():
    import torch.distributed as dist
    own = not dist.is_initialized()
    PD.fake_group()
    yield
    if own:
        dist.destroy_process_group()


def _fake(shape, mesh, placements, dtype=torch.float32):
    """A fake DTensor of global ``shape``: this rank's shard."""
    return PD.fake_dtensor(shape, dtype, mesh.device_mesh,
                           tuple(placements), "cpu")


def _count(fn, *args):
    tr = StepTrace()
    with tr.tracing():
        fn(*args)
    return tr


@pytest.mark.parametrize("sizes,xp,wp,want", [
    # (mesh, x placements, w placements, this rank's (m, k, n))
    ((2, 2), "S0,R", "R,R", (4, 16, 12)),       # output Shard
    ((2, 2), "S1,R", "S0,R", (8, 8, 12)),       # output Partial
    ((2, 2), "R,R", "R,R", (8, 16, 12)),        # output Replicate
    ((4, 2), "S0,R", "R,S1", (2, 16, 6)),       # Shard on both axes
    ((4, 2), "S1,S0", "S0,R", (4, 4, 12)),      # Partial and Shard
])
def test_sharded_matmul_counts_this_ranks_flops(fake_pg, sizes, xp, wp,
                                                want):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_mesh(sizes, ("data", "model"), "cpu")

    def parse(s):
        return [Shard(int(p[1])) if p[0] == "S" else Replicate()
                for p in s.split(",")]
    with FakeTensorMode():
        x = _fake((8, 16), mesh, parse(xp))
        w = _fake((16, 12), mesh, parse(wp))
        tr = _count(torch.matmul, x, w)
    m, k, n = want
    assert tr.flops == 2 * m * k * n
    assert tr.collectives.result()[0] == 0


def test_plain_products_count_as_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = reduced(get_config("qwen3_4b"), n_layers=2, d_model=64)
    from repro_torch.models import model as M
    params = M.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 48))

    def run():
        return M.forward(params, {"tokens": tokens}, cfg, remat=False)
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            run()
        tr = _count(run)
    assert tr.flops == fc.get_total_flops() > 0
    assert tr.ew_flops > 0


def test_shard_local_einsum_counts_as_dtensors_own(fake_pg):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import ops
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    with FakeTensorMode():
        # torch 2.13's own rule fails once heads shard too (a strided
        # shard of the flattened batch): the batch alone shards here
        q = _fake((4, 8, 6, 16), mesh, [Shard(0), Replicate()])
        k = _fake((4, 10, 6, 16), mesh, [Shard(0), Replicate()])
        eq = "bqhd,bkhd->bhqk"
        mine = _count(ops.einsum, eq, q, k)
        native = _count(torch.einsum, eq, q, k)
    assert mine.flops == native.flops == 2 * 2 * 6 * 8 * 10 * 16


def test_collectives_of_redistributes(fake_pg):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    dm = mesh.device_mesh
    with FakeTensorMode():
        x = _fake((8, 4), mesh, [Shard(0), Replicate()])
        with CollectiveCounter() as cc:
            x.redistribute(dm, [Replicate(), Replicate()])
        assert cc.result() == (8 * 4 * 4.0, {"all-gather": 8 * 4 * 4})
        p = _fake((8, 4), mesh, [Replicate(), Replicate()])
        p = torch.distributed.tensor.DTensor.from_local(
            p.to_local(), dm, [Partial(), Replicate()], run_check=False)
        with CollectiveCounter() as cc:
            p.redistribute(dm, [Replicate(), Replicate()])
        assert cc.result() == (2 * 8 * 4 * 4.0, {"all-reduce": 8 * 4 * 4})


def test_cross_pod_reduce_is_counted(fake_pg):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import cross_pod_grad_reduce
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    with FakeTensorMode():
        g = {"w": _fake((8, 6), mesh, [Replicate(), Shard(0), Shard(1)]),
             "b": _fake((6,), mesh, [Replicate()] * 3)}
        e = {k: _fake(tuple(v.shape), mesh, v.placements)
             for k, v in g.items()}
        with CollectiveCounter() as cc:
            cross_pod_grad_reduce(g, mesh, e)
    # each leaf: its int32 payload and its f32 scale, all-reduced whole
    payload = (8 * 6 + 6) * 4 + 2 * 4
    assert cc.per_op["all-reduce"] == payload
    assert cc.ops["all-reduce"] == 4


def test_one_by_one_mesh_moves_nothing(fake_pg):
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    cfg = reduced(get_config("mixtral_8x7b"), n_layers=2, d_model=64)
    for kind in ("train", "prefill", "decode"):
        rec = PD._compile(cfg, ShapeSpec("x", kind, 32, 2), mesh, True,
                          device="cpu")
        assert rec["coll_bytes_dev"] == 0 and rec["coll_ops"] == {}
        assert rec["flops_dev"] > 0 and rec["peak_gb_dev"] > 0


# ---------------------------------------------------------------------------
# FLOPs against XLA's cost analysis
# ---------------------------------------------------------------------------
XLA_CELLS = r"""
import json, sys
import jax, numpy as np
jax.devices()
import jax.numpy as jnp
import repro.launch.dryrun as RD
import repro.models.ssm as RS
from repro.configs import get_config, reduced
from repro.launch.shapes import ShapeSpec
mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))


def count(arch, kind):
    cfg = reduced(get_config(arch), n_layers=2, d_model=256)
    return RD._compile(cfg, ShapeSpec("x", kind, 256, 2), mesh,
                       unroll=True)["flops_dev"]


def hillis_steele(log_a, b, h0):
    # the port's models/ssm.py::chunked_diag_scan, in jnp
    def scan(a, b):
        n, d = a.shape[1], 1
        while d < n:
            a_r, b_r = a[:, d:], b[:, d:]
            b = jnp.concatenate([b[:, :d], a_r * b[:, :-d] + b_r], axis=1)
            a = jnp.concatenate([a[:, :d], a_r * a[:, :-d]], axis=1)
            d *= 2
        return a, b
    S = log_a.shape[1]
    C = RS._chunk_for(S)
    out, h = [], h0.astype(jnp.float32)
    for s0 in range(0, S, C):
        a_acc, b_acc = scan(jnp.exp(log_a[:, s0:s0 + C].astype(jnp.float32)),
                            b[:, s0:s0 + C].astype(jnp.float32))
        h_t = a_acc * h[:, None] + b_acc
        out.append(h_t.astype(b.dtype))
        h = h_t[:, -1]
    return jnp.concatenate(out, axis=1), h.astype(b.dtype)


res = {f"{a}|{k}": count(a, k) for a in sys.argv[1].split(",")
       for k in ("train", "prefill", "decode")}
if "falcon_mamba_7b" in sys.argv[1]:
    RS.chunked_diag_scan = hillis_steele
    for k in ("train", "prefill"):
        res[f"falcon_mamba_7b|{k}|hillis_steele"] = count("falcon_mamba_7b",
                                                          k)
print("XLA", json.dumps(res))
"""
FAMILIES = {"olmo_1b": 0.03, "mixtral_8x7b": 0.03, "falcon_mamba_7b": 0.10,
            "zamba2_1p2b": 0.03}
# port / XLA with fusion on, the count the reference's dry run records:
# each family within 3% of 1, but the SSM's train and prefill, where the
# fused count holds every duplicated producer (measured 0.809 and 0.853)
FUSED_BANDS = {"falcon_mamba_7b|train": (0.78, 0.84),
               "falcon_mamba_7b|prefill": (0.82, 0.88)}


@pytest.fixture(scope="module")
def flops(fake_pg):
    """``(xla, xla_fused, port)``: the reference's counts, with XLA's
    ``fusion`` pass off and on, from four subprocesses (started first)
    and the port's, traced meanwhile."""
    archs = list(FAMILIES)
    procs = []
    for flags in ("--xla_disable_hlo_passes=fusion", ""):
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=flags)
        procs += [subprocess.Popen([sys.executable, "-c", XLA_CELLS,
                                    ",".join(part)], env=env, text=True,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE)
                  for part in (archs[:2], archs[2:])]
    xla, xla_fused = {}, {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        port = {f"{a}|{k}": PD._compile(
            reduced(get_config(a), n_layers=2, d_model=256),
            ShapeSpec("x", k, 256, 2), mesh, True, device="cpu")["flops_dev"]
            for a in FAMILIES for k in ("train", "prefill", "decode")}
        for i, proc in enumerate(procs):
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("XLA ")]
            (xla if i < 2 else xla_fused).update(json.loads(line[-1][4:]))
    finally:
        for proc in procs:
            proc.kill()
    return xla, xla_fused, port


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_flops_against_xla(flops, arch, kind):
    xla_flops, xla_fused, port_flops = flops
    key = f"{arch}|{kind}"
    tol = 0.03 if kind == "decode" else FAMILIES[arch]
    assert port_flops[key] == pytest.approx(xla_flops[key], rel=tol)
    lo, hi = FUSED_BANDS.get(key, (0.97, 1.03))
    assert lo <= port_flops[key] / xla_fused[key] <= hi
    hs = f"{key}|hillis_steele"
    if hs in xla_flops:     # the scans swapped: the counts agree within 3%
        assert port_flops[key] == pytest.approx(xla_flops[hs], rel=0.03)
        assert port_flops[key] > xla_flops[key]
