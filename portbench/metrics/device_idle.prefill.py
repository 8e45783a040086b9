"""device_idle.prefill: % of the traced window in which no operation ran on
the card (1 - profiled busy time / window)."""
from portbench.harness import readers


def read(run):
    return readers.idle(run)
