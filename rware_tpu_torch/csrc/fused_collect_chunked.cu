// The chunked instantiations (kChunk) of the MLP collector kernel
// (collect_mlp.cuh): K2a and K2d with the observation tile built and summed in
// chunks of kx features, the weights read from device memory, FLATTENED and
// image, with and without message bits; in a translation unit of their own so
// that nvcc builds them beside fused_collect.cu's.
#include "collect_mlp.cuh"

int launch_collect_chunked(const EnvDims& d, const MlpDims& m, const CollectPlan& p, int T,
                           int B, const CollectArgs& a) {
  // [image][message]
  decltype(&fused_collect_kernel<true, false, false, true>) const kernels[2][2] = {
      {fused_collect_kernel<true, false, false, true>,
       fused_collect_kernel<true, true, false, true>},
      {fused_collect_kernel<true, false, true, true>,
       fused_collect_kernel<true, true, true, true>}};
  return launch_collect(kernels[m.obs.img_n_layers > 0][m.M > 0], d, m, p, T, B, a);
}
