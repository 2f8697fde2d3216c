// The chunked image instantiations (kImage, kChunk) of the recurrent collector
// kernel (collect_gru.cuh): K2d′ on IMAGE and IMAGE_DICT observations built
// and embedded in chunks of kx features, at every message width, in a
// translation unit of their own.
#include "collect_gru.cuh"

int launch_collect_gru_chunked_image(const EnvDims& d, const GruCollectDims& m,
                                     const GruCollectPlan& p, int T, int B,
                                     const GruCollectArgs& a) {
  return launch_collect_gru<true, true, true>(d, m, p, T, B, a);
}
