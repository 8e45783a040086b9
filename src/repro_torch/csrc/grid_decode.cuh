// Flat stream index -> grid point decode of the standalone decode kernel
// (grid_decode.cu), by runtime divisions.  The fused sweep megakernel
// (fused_sweep.cu) decodes the same indices by exact magic multipliers
// instead; tests/test_torch_fused_sweep.py holds that arithmetic equal to
// this one's twin at the int32 ceiling and on int64.
//
// Same arithmetic as the reference's
// repro/kernels/grid_decode.py::decode_axis_values and the host oracle
// repro_torch.core.grid.ChunkedGrid: variant-major flat indices, C order
// within a variant, the tail clamped to total - 1 (callers mask it).

#pragma once

// Decodes flat index `o` into its variant slot (returned) and its n_axes
// axis values, read from the (n_axes, table_cols) f32 axis table `tab`
// (row a holds variant v's values at columns v * lmax ...).  Value a is
// written to vals[a * vstride].
template <typename IdxT>
__device__ __forceinline__ int decode_index(
    IdxT o, IdxT total, IdxT n_var, int n_axes, const long long* shape,
    const long long* stride, const float* tab, int table_cols, int lmax,
    float* vals, long long vstride) {
  const IdxT oc = o < total - 1 ? o : total - 1;   // clamp the tail
  const IdxT vid = oc / n_var;
  const IdxT local = oc - vid * n_var;
  for (int a = 0; a < n_axes; ++a) {
    const IdxT ia = (local / (IdxT)stride[a]) % (IdxT)shape[a];
    vals[a * vstride] = tab[a * table_cols + (int)vid * lmax + (int)ia];
  }
  return (int)vid;
}
