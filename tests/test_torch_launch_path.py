"""The launch path every CUDA wrapper shares
(``repro_torch.kernels.cuda_build.launch``), on the CPU with the CUDA calls
it makes stood in for: PyTorch's raw current-stream call, its current-device
call and the ``torch.cuda.device`` context manager.

The path passes the current stream of the operands' device as the C
entry's last argument, calls the entry on the current device when that
is the operands' device (no context manager), switches to the operands'
device only when it is another one (and back after the call), and raises
on a nonzero ``cudaError_t``.  The stream is read anew at every call, so
a caller's ``torch.cuda.stream(...)`` context is honoured.
"""
import pytest
import torch

from repro_torch.kernels import cuda_build


@pytest.fixture
def fake_cuda(monkeypatch):
    """Device 0 current; streams ``state["stream"]`` + index (1000 to
    begin with); every switch recorded."""
    state = {"current": 0, "switched_to": [], "stream": 1000}

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            state["switched_to"].append(self.index)
            self.prev = state["current"]
            state["current"] = self.index

        def __exit__(self, *exc):
            state["current"] = self.prev
            return False

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: state["stream"] + index,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice",
                        lambda: state["current"], raising=False)
    monkeypatch.setattr(torch.cuda, "device", Device)
    return state


def _entry(state, calls, err=0):
    """A C entry's stand-in: records its arguments and the device current
    at the call."""
    def entry(*args):
        calls.append((args, state["current"]))
        return err
    return entry


def test_launch_on_the_current_device_passes_its_stream(fake_cuda):
    calls = []
    cuda_build.launch("probe", _entry(fake_cuda, calls),
                      torch.device("cuda", 0), 7, 8.5)
    assert calls == [((7, 8.5, 1000), 0)]
    assert fake_cuda["switched_to"] == []


def test_launch_on_a_second_device_switches_to_it_and_back(fake_cuda):
    calls = []
    cuda_build.launch("probe", _entry(fake_cuda, calls),
                      torch.device("cuda", 1), 7)
    assert calls == [((7, 1001), 1)]
    assert fake_cuda["switched_to"] == [1]
    assert fake_cuda["current"] == 0


@pytest.mark.parametrize("index", [0, 1])
def test_launch_raises_on_a_nonzero_cuda_error(fake_cuda, index):
    calls = []
    with pytest.raises(RuntimeError, match="probe kernel launch failed: "
                                           "cudaError_t 700"):
        cuda_build.launch("probe", _entry(fake_cuda, calls, err=700),
                          torch.device("cuda", index))
    assert len(calls) == 1 and fake_cuda["current"] == 0


def test_launch_reads_the_current_stream_at_every_call(fake_cuda):
    calls = []
    entry = _entry(fake_cuda, calls)
    cuda_build.launch("probe", entry, torch.device("cuda", 0))
    fake_cuda["stream"] = 2000          # the caller entered another stream
    cuda_build.launch("probe", entry, torch.device("cuda", 0))
    cuda_build.launch("probe", entry, torch.device("cuda", 1))
    assert calls == [((1000,), 0), ((2000,), 0), ((2001,), 1)]
