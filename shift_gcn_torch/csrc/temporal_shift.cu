// Fractional temporal shift, forward (eval path).
//
// Replaces the Pallas TPU kernel of the reference package,
// ops/pallas/temporal_shift_kernel.py::_tshift_kernel (hat mode, reached
// through temporal_shift_pallas / _run_tshift).  Per channel c:
//
//   y      = ypos[c] + (stride != 1 ? 0.5 : 0)
//   lo     = floor(y),  f = y - lo
//   out[n, t, v, c] = (1 - f) * x[n, t*stride + lo, v, c]
//                   +      f  * x[n, t*stride + lo + 1, v, c]
//
// with reads outside [0, T_in) taken as zero.
//
// Bound on the H100: memory.  Three flops per output against one read of
// the input and one write of the output, so the floor is
// (N*T_in*V*C + N*T_out*V*C) * bytes / 3.35 TB/s.  The Pallas version
// zero-padded T on the XLA side and summed 2*max_shift+2 taps; here each
// output reads its two source frames directly (no padded copy, no dead
// taps).  A block owns one output frame row (n, t) and its threads walk
// the V*C elements of that row, so neighbouring threads touch neighbouring
// channels: the stores are fully coalesced and the loads are coalesced
// within each group of channels that share a source frame.  Math is fp32,
// I/O fp32 or bf16; products and the sum are rounded separately
// (__fmul_rn/__fadd_rn) so the result equals the plain PyTorch version
// bit for bit in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
tshift_kernel(const T* __restrict__ x, const float* __restrict__ ypos,
              T* __restrict__ out, int t_in, int t_out, int vc, int c,
              int stride, float offset) {
  const int row = blockIdx.x;  // n * t_out + t
  const int n = row / t_out;
  const int t = row - n * t_out;
  const T* xn = x + static_cast<int64_t>(n) * t_in * vc;
  T* orow = out + static_cast<int64_t>(row) * vc;
  for (int e = threadIdx.x; e < vc; e += kThreads) {
    const int ch = e % c;
    const float y = ypos[ch] + offset;
    const float lo_f = floorf(y);
    const float f = y - lo_f;
    const int t0 = t * stride + static_cast<int>(lo_f);
    const int t1 = t0 + 1;
    const float x0 =
        (t0 >= 0 && t0 < t_in) ? load_f(xn + static_cast<int64_t>(t0) * vc + e)
                               : 0.0f;
    const float x1 =
        (t1 >= 0 && t1 < t_in) ? load_f(xn + static_cast<int64_t>(t1) * vc + e)
                               : 0.0f;
    store_f(orow + e,
            __fadd_rn(__fmul_rn(1.0f - f, x0), __fmul_rn(f, x1)));
  }
}

}  // namespace

extern "C" int temporal_shift_forward(const void* x, const void* ypos,
                                      void* out, int n, int t_in, int t_out,
                                      int v, int c, int stride, int is_bf16,
                                      void* stream) {
  const int rows = n * t_out;
  if (rows == 0 || v * c == 0) return 0;
  const float offset = stride != 1 ? 0.5f : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    tshift_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ypos),
        static_cast<__nv_bfloat16*>(out), t_in, t_out, v * c, c, stride,
        offset);
  } else {
    tshift_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(ypos),
        static_cast<float*>(out), t_in, t_out, v * c, c, stride, offset);
  }
  return static_cast<int>(cudaGetLastError());
}
