// Division by exact magic multipliers, the flat-index decode's only
// arithmetic in the fused sweep megakernel (fused_sweep.cu, K1) and the
// standalone decode kernel (grid_decode.cu, K2).
//
// The host makes the multiplier m and shift s of each divisor d (n_var and
// every axis size) with repro_torch/kernels/grid_decode.py::magic; then
// floor(n / d) == (umulhi(n, m) + n) >> s, exactly, for n < 2^31 at 32
// bits and n < 2^63 at 64 (Granlund & Montgomery, PLDI'94, Fig. 4.1; the
// bound on n keeps the sum in range).  tests/test_torch_fused_sweep.py
// holds the arithmetic to floor division at the edges of each divisor and
// dividend range; tests/test_torch_grid_decode_plan.py holds K2's decode
// built on it to grid_decode_torch.

#pragma once

namespace {

__device__ __forceinline__ unsigned int fdiv(unsigned int n, unsigned int m,
                                             int s) {
  return (__umulhi(n, m) + n) >> s;
}
__device__ __forceinline__ unsigned long long fdiv(unsigned long long n,
                                                   unsigned long long m,
                                                   int s) {
  return (__umul64hi(n, m) + n) >> s;
}

}  // namespace
