"""mfu.train: the whole step's share of the bf16 peak, from the operations
it needs (``flops.train_step_flops``) over the traced window's seconds."""
from portbench.harness import flops, readers


def read(run):
    return readers.mfu(run, flops.train_step_flops)
