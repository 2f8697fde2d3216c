// The FLATTENED instantiations of K2c (one weight stack for all agents) of the
// recurrent collector kernel (collect_gru.cuh) at every message width, in a
// translation unit of their own so that nvcc builds them beside K2d′'s
// (fused_collect_gru.cu).
#include "collect_gru.cuh"

int launch_collect_gru_one_stack(const EnvDims& d, const GruCollectDims& m,
                                 const GruCollectPlan& p, int T, int B, const GruCollectArgs& a) {
  return launch_collect_gru<false, false, false>(d, m, p, T, B, a);
}
