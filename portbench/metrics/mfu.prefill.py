"""mfu.prefill: the whole call's share of the bf16 peak, from the operations
it needs (``flops.prefill_flops``) over the traced window's seconds."""
from portbench.harness import flops, readers


def read(run):
    return readers.mfu(run, flops.prefill_flops)
