"""The metric arithmetic on fixed numbers: operation counts, the
readers, and the reading of a trace."""
import pytest
from torch.autograd import DeviceType

from portbench.harness import device, flops, readers
from portbench.harness import manifest as mf
from portbench.harness.loop import Window

OLMO = mf.read_json(mf.BENCH / "configs" / "olmo-1b.json")["arch"]
GRANITE = mf.read_json(mf.BENCH / "configs" /
                       "granite-3.0-1b-a400m.json")["arch"]


def test_counts_by_hand():
    # OLMo-1B: 16 x (4 * 2048^2 + 3 * 2048 * 8192) outside the embedding
    assert flops.matmul_params(OLMO) == 16 * (4 * 2048 ** 2
                                              + 3 * 2048 * 8192)
    n = flops.matmul_params(OLMO) + 50304 * 2048
    attn = 4 * 128 * 16 * 16 * 8 * (2048 * 2049 // 2)
    assert flops.train_step_flops(OLMO, 8, 2048) == \
        6 * n * 8 * 2048 + 3 * attn
    assert flops.prefill_flops(OLMO, 8, 2048) == \
        2 * (n - 50304 * 2048) * 8 * 2048 + 2 * 50304 * 2048 * 8 + attn
    # Granite: 8 of 32 experts of width 512 a token, and the router
    per_layer = (1024 * 1024 * 2 + 2 * 1024 * 512) + 8 * 3 * 1024 * 512 \
        + 1024 * 32
    assert flops.matmul_params(GRANITE) == 24 * per_layer


def _run(profile=None, units=10, seconds=2.0, kind="NVIDIA H100 80GB HBM3"):
    win = Window(units=units, seconds=seconds,
                 attempted=units, failed=0,
                 spans={"grads": [900.0, 910.0], "adamw": [90.0, 92.0]},
                 profile=profile)
    return readers.Run(OLMO, {"batch": 8, "seq": 2048}, win, kind)


def test_readers_on_fixed_numbers():
    prof = {"busy_s": 1.9, "window_s": 2.0,
            "by_class_s": {"gemm": 0.5, "elementwise": 1.2}}
    run = _run(prof)
    work = flops.train_step_flops(OLMO, 8, 2048) * 10
    assert readers.span_ms(run, "grads") == pytest.approx(905.0)
    assert readers.mfu(run, flops.train_step_flops) == \
        pytest.approx(100 * work / 2.0 / 989e12)
    assert readers.roofline(run, flops.train_step_flops, ("gemm",)) == \
        pytest.approx(100 * work / 0.5 / 989e12)
    assert readers.class_ms(run, "elementwise") == pytest.approx(120.0)
    assert readers.idle(run) == pytest.approx(5.0)


def test_gemm_roofline_keeps_attention_on_both_sides():
    """Attention's products are counted, and the kernels that compute
    them timed, wherever attention runs: on cuBLAS inside ``gemm``, or
    on a fused kernel of its own class."""
    work = flops.train_step_flops(OLMO, 8, 2048) * 10
    reader = mf.reader("gemm_roofline.train")
    on_cublas = {"busy_s": 1.9, "window_s": 2.0,
                 "by_class_s": {"gemm": 0.6, "elementwise": 1.2}}
    fused = {"busy_s": 1.9, "window_s": 2.0,
             "by_class_s": {"gemm": 0.5, "attention": 0.1,
                            "elementwise": 1.2}}
    assert reader.read(_run(on_cublas)) == pytest.approx(
        100 * work / 0.6 / 989e12)
    assert reader.read(_run(fused)) == pytest.approx(
        reader.read(_run(on_cublas)))
    assert device.kernel_class("flash_attention_wgmma_kernel") == \
        "attention"
    assert device.kernel_class("nvjet_tst_256x128_64x4_1x2_h_bz") == "gemm"


def test_readers_find_nothing():
    run = _run(None)
    assert readers.roofline(run, flops.train_step_flops, ("gemm",)) is None
    assert readers.class_ms(run, "elementwise") is None
    assert readers.idle(run) is None
    assert readers.span_ms(run, "nothing") is None
    assert readers.mfu(_run(None, kind="cpu"), flops.train_step_flops) \
        is None
    prof = {"busy_s": 1.0, "window_s": 2.0, "by_class_s": {"gemm": 0.0}}
    assert readers.roofline(_run(prof), flops.train_step_flops,
                            ("gemm", "attention")) is None


def test_every_reader_file_reads():
    for m in mf.load_manifest()["per_layer"]:
        r = mf.reader(m["name"])
        assert r.read(_run(None)) is None or m["source"] in (
            "program_span", "host_clock")


class _Ev:
    def __init__(self, name, dev, s, e, corr, act=""):
        self._v = (name, dev, s, e, corr, act)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def activity_type(self):
        return self._v[5]


class _Prof:
    def __init__(self, evs):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events":
                                                      lambda s: evs})()


CPU, GPU = DeviceType.CPU, DeviceType.CUDA
MS = 1_000_000


def _trace(drop=False):
    evs = [_Ev("portbench.grads", CPU, 0, 60 * MS, 0),
           _Ev("aten::mm", CPU, 1 * MS, 2 * MS, 0),
           _Ev("cudaLaunchKernel", CPU, 1 * MS, 2 * MS, 11),
           _Ev("aten::add_", CPU, 39 * MS, 55 * MS, 0),
           _Ev("cudaLaunchKernel", CPU, 50 * MS, 51 * MS, 12),
           _Ev("portbench.grads", GPU, 0, 100 * MS, 0, "gpu_user_annotation"),
           _Ev("nvjet_hsh_128x256_gemm", GPU, 2 * MS, 40 * MS, 11)]
    if not drop:
        evs.append(_Ev("vectorized_elementwise_kernel", GPU, 52 * MS,
                       100 * MS, 12))
    return _Prof(evs)


def test_summarize_fixed_trace():
    s = device.summarize(_trace(), 0.1)
    assert s["busy_s"] == pytest.approx(0.086)
    assert s["by_class_s"] == pytest.approx({"gemm": 0.038,
                                             "elementwise": 0.048})
    assert s["device_ops"][0] == ["vectorized_elementwise_kernel",
                                  pytest.approx(0.048)]
    # the gap 40..52 ms: the host was in aten::add_ under portbench.grads
    assert s["idle_gaps"] == [["portbench.grads > aten::add_",
                               pytest.approx(0.012)]]


def test_summarize_refuses_dropped_records():
    with pytest.raises(RuntimeError, match="dropped"):
        device.summarize(_trace(drop=True), 0.1)
    with pytest.raises(RuntimeError, match="dropped"):
        device.summarize(_trace(), 0.5)     # activity stops short
