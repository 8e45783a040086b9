"""grads_ms.train: CUDA-event ms of the traced window's calls of
``repro_torch.train.steps.value_and_grad`` (forward, remat and backward),
averaged over its steps."""
from portbench.harness import readers


def read(run):
    return readers.span_ms(run, "grads")
