"""Charging device time to the program's spans
(:mod:`portbench.harness.spans`) on a fixed trace: a forward kernel, a
backward kernel on another thread charged through its forward
operation's ``sequence_nr``, a recomputed forward on the backward
thread, inside a span and outside every span, a memset, and an
unspanned kernel."""
import pytest
from torch.autograd import DeviceType

from portbench.harness import device, spans

CPU, GPU = DeviceType.CPU, DeviceType.CUDA
MS = 1_000_000
FWD, BWD = 1, 2                 # the forward and the autograd threads


class _Ev:
    def __init__(self, name, dev, s, e, corr=0, act="cpu_op", tid=FWD,
                 seq=-1, fwd=0):
        self._v = dict(name=name, dev=dev, s=s * MS, e=e * MS, corr=corr,
                       act=act, tid=tid, seq=seq, fwd=fwd)

    def name(self):
        return self._v["name"]

    def device_type(self):
        return self._v["dev"]

    def start_ns(self):
        return self._v["s"]

    def end_ns(self):
        return self._v["e"]

    def correlation_id(self):
        return self._v["corr"]

    def activity_type(self):
        return self._v["act"]

    def start_thread_id(self):
        return self._v["tid"]

    def fwd_thread_id(self):
        return self._v["fwd"]

    def sequence_nr(self):
        return self._v["seq"]


def _launch(s, corr, tid=FWD, name="cudaLaunchKernel"):
    return _Ev(name, CPU, s, s + 1, corr, "cuda_runtime", tid)


def _kernel(name, s, e, corr, act="kernel"):
    return _Ev(name, GPU, s, e, corr, act)


def _trace():
    return [
        _Ev("portbench.grads", CPU, 0, 100, act="user_annotation"),
        # an op that makes no node carries the next node's number
        _Ev("aten::arange", CPU, 5, 6, seq=7),
        _Ev("repro_torch.mlp", CPU, 10, 20, act="user_annotation"),
        _Ev("aten::mm", CPU, 11, 15, seq=7),
        _launch(12, 101),
        _Ev("repro_torch.norm", CPU, 21, 25, act="user_annotation"),
        _launch(22, 104, name="cudaMemsetAsync"),
        _launch(26, 105),
        _Ev("autograd::engine::evaluate_function: MmBackward0", CPU, 50,
            70, tid=BWD, seq=7, fwd=FWD),
        _launch(55, 102, tid=BWD),
        # the recompute of a checkpointed layer, inside the backward node
        _Ev("repro_torch.attention", CPU, 57, 65, act="user_annotation",
            tid=BWD),
        # a host operation's own correlation id is another numbering
        _Ev("aten::_softmax", CPU, 59, 63, 105, tid=BWD, seq=3),
        _launch(60, 103, tid=BWD),
        # a recomputed operation outside every span (a residual add)
        _Ev("aten::add", CPU, 66, 69, tid=BWD, seq=4),
        _launch(67, 106, tid=BWD),
        _Ev("repro_torch.mlp", GPU, 30, 40, act="gpu_user_annotation"),
        _Ev("portbench.grads", GPU, 0, 100, act="gpu_user_annotation"),
        _kernel("nvjet_tst_128x256_gemm", 30, 40, 101),
        _kernel("vectorized_elementwise_kernel", 71, 80, 102),
        _kernel("softmax_warp_forward", 81, 85, 103),
        _kernel("Memset (Device)", 86, 88, 104, act="gpu_memset"),
        _kernel("unrolled_elementwise_kernel_direct_copy", 89, 100, 105),
        _kernel("vectorized_elementwise_kernel_add", 100, 102, 106),
    ]


def test_each_device_event_charged_once():
    got = {ev.correlation_id(): span
           for ev, span, _ in spans.charge(_trace())}
    assert got == {101: "mlp",          # forward, under its span
                   102: "mlp",          # backward, through seq 7
                   103: "attention",    # recompute, on the backward thread
                   104: "norm",         # a memset by correlation
                   105: spans.UNSPANNED,
                   106: spans.UNSPANNED}    # recomputed, outside spans


def test_tally_sums_to_the_busy_union():
    t = spans.tally(spans.charge(_trace()))
    assert t["by_span_s"] == pytest.approx(
        {"mlp": 0.019, "attention": 0.004, "norm": 0.002,
         spans.UNSPANNED: 0.013})
    assert t["by_span_events"] == {"mlp": 2, "attention": 1, "norm": 1,
                                   spans.UNSPANNED: 2}
    assert t["by_span_class_s"]["mlp"] == pytest.approx(
        {"gemm": 0.010, "elementwise": 0.009})
    assert t["by_span_class_s"]["attention"] == pytest.approx(
        {"softmax": 0.004})
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("K", (), {
        "events": lambda s: _trace()})()
    busy = device.summarize(prof, 0.07)["busy_s"]
    assert t["device_s"] == pytest.approx(busy)
    assert sum(t["by_span_s"].values()) == pytest.approx(busy)


def test_a_launch_without_its_runtime_call_is_unspanned():
    evs = [e for e in _trace() if e.correlation_id() != 102
           or e.device_type() == GPU]
    got = {ev.correlation_id(): (span, launch)
           for ev, span, launch in spans.charge(evs)}
    assert got[102] == (spans.UNSPANNED, None)


def test_device_ms_reads_the_tally():
    prof = spans.tally(spans.charge(_trace()))
    assert spans.device_ms(prof, 2, ("mlp",)) == pytest.approx(9.5)
    assert spans.device_ms(prof, 2, ("norm", "attention")) == \
        pytest.approx(3.0)
    assert spans.device_ms(prof, 2, ("kv_cache",)) is None
    assert spans.device_ms(None, 2, ("mlp",)) is None
    assert spans.device_ms({"busy_s": 1.0}, 2, ("mlp",)) is None


def test_groups_name_the_program_spans():
    from repro_torch.spans import PREFIX, SPANS
    assert PREFIX == spans.PREFIX
    for kind, groups in spans.GROUPS.items():
        names = [n for g in groups.values() for n in g]
        assert len(names) == len(set(names)), kind
        assert set(names) <= set(SPANS) | {spans.UNSPANNED}, kind
    used = {n for g in spans.GROUPS.values() for v in g.values() for n in v}
    assert used == set(SPANS) | {spans.UNSPANNED}


def test_report_labels_the_unspanned_launches():
    from portbench import span_report
    trace = _trace()
    detail = span_report._unspanned_detail(spans.charge(trace), trace)
    assert detail["by_kernel_s"] == [
        ["unrolled_elementwise_kernel_direct_copy", pytest.approx(0.011)],
        ["vectorized_elementwise_kernel_add", pytest.approx(0.002)]]
    assert detail["by_host_op_s"] == [
        ["portbench.grads", pytest.approx(0.011)],
        ["aten::add", pytest.approx(0.002)]]


def test_sweep_gives_the_stack_at_each_point():
    ranges = [(0, 100, "outer"), (10, 20, "a"), (12, 15, "a1"),
              (20, 30, "b")]
    points = [(5, "p5"), (13, "p13"), (20, "p20"), (31, "p31"),
              (0, "p0")]
    assert spans.sweep(ranges, points) == {
        "p0": ("outer",), "p5": ("outer",), "p13": ("outer", "a", "a1"),
        "p20": ("outer", "a", "b"), "p31": ("outer",)}
