// The image instantiations (K2e, IMAGE and IMAGE_DICT observations) of the
// recurrent collector kernel (collect_gru.cuh): K2c and K2d′ at every message
// width, in a translation unit of their own so that nvcc builds them beside
// fused_collect_gru.cu's FLATTENED ones.
#include "collect_gru.cuh"

int launch_collect_gru_image(const EnvDims& d, const GruCollectDims& m, const GruCollectPlan& p,
                             int T, int B, const GruCollectArgs& a) {
  return launch_collect_gru<true, false>(d, m, p, T, B, a);
}
