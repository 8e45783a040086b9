"""elementwise_ms.prefill: profiled device ms a call of torch's elementwise
kernels (names holding ``elementwise_kernel``)."""
from portbench.harness import readers


def read(run):
    return readers.class_ms(run, "elementwise")
