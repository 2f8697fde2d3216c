// The chunked FLATTENED instantiations (kChunk) of the recurrent collector
// kernel (collect_gru.cuh): K2d′ with the observation tile built and embedded
// in chunks of kx features, at every message width, in a translation unit of
// their own so that nvcc builds them beside the other collector sources.
#include "collect_gru.cuh"

int launch_collect_gru_chunked(const EnvDims& d, const GruCollectDims& m,
                               const GruCollectPlan& p, int T, int B, const GruCollectArgs& a) {
  return launch_collect_gru<true, false, true>(d, m, p, T, B, a);
}
