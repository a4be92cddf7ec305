// An empty kernel behind the same ctypes path as K1 and K2. Timing it gives
// the launch floor a wrapper call cannot go below: the Python call, the
// ctypes crossing and one kernel launch with no work. Beside it, one
// thread's chain of dependent f32 adds: its time over its length is the
// latency of one __fadd_rn, which with the longest per-bin chain of a K3a
// call gives that call's order floor. Used by chip_smoke.py only; no path
// of the port launches either.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void add_chain_kernel(float* out, int n, float x) {
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, x);
  *out = acc;
}

}  // namespace

extern "C" int delphi_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// n dependent adds of x to 0.0f in one thread; the sum lands in *out.
extern "C" int delphi_add_chain(float* out, int n, float x, void* stream) {
  add_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, n, x);
  return static_cast<int>(cudaGetLastError());
}
