// The nurbs build (B_NURBS: the tilts and K6d, NURBS surfaces) of the fused
// merit kernels (K2/K3): the kernel templates of fused_trace.cuh instantiated
// for it alone, in a source of its own so that nvcc builds it beside the
// others and their machine code stays as it was. Its C entries are the other
// builds' with "_nurbs" after the kernel's name
// (otc_<kernel>_nurbs_<f32|f64>), which the op modules call for a spec of the
// nurbs build (ops/launch.py: entry_name). The device step is
// nurbs_step.cuh's.
//
// Every extern "C" entry launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include "fused_trace.cuh"

OTC_FWD(f32, float, _nurbs, true)
OTC_FWD(f64, double, _nurbs, true)
OTC_BWD(f32, float, _nurbs, true)
OTC_BWD(f64, double, _nurbs, true)

#define OTC_OCC(SUF, T)                                                      \
  extern "C" int otc_merit_bwd_occupancy_nurbs_##SUF(                        \
      int build, int block, int64_t dyn, int* out) {                         \
    return merit_bwd_occupancy<T, true>(build, block, dyn, out);             \
  }
OTC_OCC(f32, float)
OTC_OCC(f64, double)
