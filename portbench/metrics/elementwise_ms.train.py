"""elementwise_ms.train: profiled device ms a step of torch's elementwise
kernels (names holding ``elementwise_kernel``)."""
from portbench.harness import readers


def read(run):
    return readers.class_ms(run, "elementwise")
