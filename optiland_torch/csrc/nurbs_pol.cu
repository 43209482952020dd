// The nurbs build (B_NURBS: the tilts and K6d, NURBS surfaces) of the
// polarized trace kernels (K8/K9): the kernel templates of pol_trace.cuh
// instantiated for it alone, in a source of its own so that nvcc builds it
// beside the others and their machine code stays as it was. Its C entries are
// the other builds' with "_nurbs" after the kernel's name
// (otc_<kernel>_nurbs_<f32|f64>), which the op modules call for a spec of the
// nurbs build (ops/launch.py: entry_name). The device step is
// nurbs_step.cuh's.
//
// Every extern "C" entry launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include "pol_trace.cuh"

OTC_POL(f32, float, _nurbs, true)
OTC_POL(f64, double, _nurbs, true)
