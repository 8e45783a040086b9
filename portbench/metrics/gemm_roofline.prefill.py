"""gemm_roofline.prefill: the product kernels' share of the bf16 peak.

The products the call needs, with the weights and attention's (all of
``flops.prefill_flops``), over the profiled device time of the kernels
that compute them: cuBLAS's GEMMs (class ``gemm``) and fused attention
(class ``attention``).  Attention's products and its kernels' time
stay on their sides wherever attention runs, so moving it off cuBLAS
moves the reading only by what the new kernel takes."""
from portbench.harness import flops, readers


def read(run):
    return readers.roofline(run, flops.prefill_flops,
                            ("gemm", "attention"))
