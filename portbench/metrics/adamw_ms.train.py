"""adamw_ms.train: CUDA-event ms of the traced window's calls of
``repro_torch.optim.adamw_update`` (clip and AdamW), averaged over its
steps."""
from portbench.harness import readers


def read(run):
    return readers.span_ms(run, "adamw")
