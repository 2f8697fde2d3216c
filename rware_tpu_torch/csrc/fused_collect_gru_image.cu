// The per-agent image instantiations (K2d′ with K2e, IMAGE and IMAGE_DICT
// observations) of the recurrent collector kernel (collect_gru.cuh) at every
// message width, in a translation unit of their own so that nvcc builds them
// beside the other collector sources.
#include "collect_gru.cuh"

int launch_collect_gru_image(const EnvDims& d, const GruCollectDims& m, const GruCollectPlan& p,
                             int T, int B, const GruCollectArgs& a) {
  return launch_collect_gru<true, true, false>(d, m, p, T, B, a);
}
