// Fractional temporal shift: forward (K1) and its constraint backward
// (K2 grad_input, K3 position grad).
//
// Replaces the Pallas TPU kernel of the reference package,
// ops/pallas/temporal_shift_kernel.py::_tshift_kernel, in its three uses:
// hat mode through temporal_shift_pallas / _fwd (K1), hat mode on the
// zero-dilated cotangent with negated positions from _bwd (K2), and diff
// mode plus the fp32 reduction from _bwd (K3).  Per channel c:
//
//   y      = ypos[c] + (stride != 1 ? 0.5 : 0)
//   lo     = floor(y),  f = y - lo
//   out[n, t, v, c] = (1 - f) * x[n, t*stride + lo, v, c]
//                   +      f  * x[n, t*stride + lo + 1, v, c]
//
// with reads outside [0, T_in) taken as zero.
//
// All three are bound by memory on the H100: a few flops per element
// against one read of each input and one write of each output, so the
// floor is the bytes over 3.35 TB/s.  Designs:
//
// K1  A block owns one output frame row (n, t) and its threads walk the
//     V*C elements of that row: stores fully coalesced, loads coalesced
//     within each group of channels that share a source frame.  The
//     Pallas version zero-padded T and summed 2*max_shift+2 taps; here
//     each output reads its two source frames directly.
// K2  The exact transpose of K1, one thread per input element with the
//     same row walk: input frame t gathers (1 - f) * g[(t - lo) / s] and
//     f * g[(t - lo - 1) / s], each only where the offset is a
//     non-negative multiple of s below T_out * s (the stride-2 evenness
//     rule).  The Pallas version built the zero-dilated cotangent in
//     memory and ran the forward with -y; nothing is dilated here.
// K3  gy_raw[c] = sum_{t,v} mean_n (x[t*s+lo+1] - x[t*s+lo]) * g[t] in
//     fp32, in a fixed order with no floating-point atomics: the sign of
//     gy_raw at a tie sits at roundoff scale, so a run-to-run order would
//     make training nondeterministic.  Pass 1: a block owns a chunk of
//     (n, t, v) rows and 32 channels (one warp's coalesced 32 channels x
//     8 row lanes), each lane sums its rows in order, the 8 lanes are
//     summed in order into one scratch row of per-chunk partials.  Pass
//     2: per channel, 8 lanes sum the chunk partials in order, then the
//     lanes in order, divided by N.
//
// Math is fp32, I/O fp32 or bf16.  In K1 and K2 products and the sum are
// rounded separately (__fmul_rn/__fadd_rn) so the result equals the
// plain PyTorch version bit for bit in fp32.

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
constexpr int kLaneCh = 32;               // K3: channels per block
constexpr int kLaneRows = kThreads / kLaneCh;  // K3: row lanes per block

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
tshift_grad_input_kernel(const T* __restrict__ g,
                         const float* __restrict__ ypos, T* __restrict__ out,
                         int t_in, int t_out, int vc, int c, int stride,
                         float offset) {
  const int row = blockIdx.x;  // n * t_in + t
  const int n = row / t_in;
  const int t = row - n * t_in;
  const T* gn = g + static_cast<int64_t>(n) * t_out * vc;
  T* orow = out + static_cast<int64_t>(row) * vc;
  const int k_end = t_out * stride;
  for (int e = threadIdx.x; e < vc; e += kThreads) {
    const int ch = e % c;
    const float y = ypos[ch] + offset;
    const float lo_f = floorf(y);
    const float f = y - lo_f;
    const int k0 = t - static_cast<int>(lo_f);  // reads output frame k0/s
    const int k1 = k0 - 1;
    const float a = (k0 >= 0 && k0 < k_end && k0 % stride == 0)
                        ? load_f(gn + static_cast<int64_t>(k0 / stride) * vc + e)
                        : 0.0f;
    const float b = (k1 >= 0 && k1 < k_end && k1 % stride == 0)
                        ? load_f(gn + static_cast<int64_t>(k1 / stride) * vc + e)
                        : 0.0f;
    store_f(orow + e, __fadd_rn(__fmul_rn(1.0f - f, a), __fmul_rn(f, b)));
  }
}

// pass 1: partial[chunk, c] = sum over the chunk's (n, t, v) rows of
// (x[t*s+lo+1] - x[t*s+lo]) * g, lanes in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
tshift_position_partial_kernel(const T* __restrict__ x,
                               const T* __restrict__ g,
                               const float* __restrict__ ypos,
                               float* __restrict__ partial, int t_in,
                               int t_out, int v, int c, int stride,
                               float offset, int rows, int rows_per_chunk) {
  __shared__ float lanes[kLaneRows][kLaneCh];
  const int ch = blockIdx.y * kLaneCh + threadIdx.x;
  const int chunk = blockIdx.x;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(rows, r_begin + rows_per_chunk);
  float acc = 0.0f;
  if (ch < c) {
    const int lo = static_cast<int>(floorf(ypos[ch] + offset));
    for (int r = r_begin + threadIdx.y; r < r_end; r += kLaneRows) {
      const int j = r % v;         // r = (n * t_out + t) * v + j
      const int nt = r / v;
      const int n = nt / t_out;
      const int t = nt - n * t_out;
      const int t0 = t * stride + lo;
      const int t1 = t0 + 1;
      const int64_t base = static_cast<int64_t>(n) * t_in;
      const float x0 =
          (t0 >= 0 && t0 < t_in)
              ? load_f(x + ((base + t0) * v + j) * static_cast<int64_t>(c) + ch)
              : 0.0f;
      const float x1 =
          (t1 >= 0 && t1 < t_in)
              ? load_f(x + ((base + t1) * v + j) * static_cast<int64_t>(c) + ch)
              : 0.0f;
      const float gv = load_f(g + static_cast<int64_t>(r) * c + ch);
      acc = fmaf(x1 - x0, gv, acc);
    }
  }
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kLaneRows; ++k) s += lanes[k][threadIdx.x];
    partial[static_cast<int64_t>(chunk) * c + ch] = s;
  }
}

// pass 2: gy_raw[c] = (sum over chunks of partial[chunk, c]) / N
__global__ void __launch_bounds__(kThreads)
tshift_position_final_kernel(const float* __restrict__ partial,
                             float* __restrict__ out, int chunks, int c,
                             float n) {
  __shared__ float lanes[kLaneRows][kLaneCh];
  const int ch = blockIdx.x * kLaneCh + threadIdx.x;
  float acc = 0.0f;
  if (ch < c) {
    for (int k = threadIdx.y; k < chunks; k += kLaneRows) {
      acc += partial[static_cast<int64_t>(k) * c + ch];
    }
  }
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kLaneRows; ++k) s += lanes[k][threadIdx.x];
    out[ch] = s / n;
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

extern "C" int temporal_shift_grad_input(const void* g, const void* ypos,
                                         void* out, int n, int t_in,
                                         int t_out, int v, int c, int stride,
                                         int is_bf16, void* stream) {
  const int rows = n * t_in;
  if (rows == 0 || v * c == 0) return 0;
  const float offset = stride != 1 ? 0.5f : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    tshift_grad_input_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(ypos),
        static_cast<__nv_bfloat16*>(out), t_in, t_out, v * c, c, stride,
        offset);
  } else {
    tshift_grad_input_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(ypos),
        static_cast<float*>(out), t_in, t_out, v * c, c, stride, offset);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int temporal_shift_position_grad(
    const void* x, const void* g, const void* ypos, void* partial, void* out,
    int n, int t_in, int t_out, int v, int c, int stride, int is_bf16,
    int chunks, void* stream) {
  if (c == 0) return 0;
  const int rows = n * t_out * v;
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_chunk = (rows + chunks - 1) / chunks;
  const float offset = stride != 1 ? 0.5f : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kLaneCh, kLaneRows);
  const dim3 grid1(chunks, (c + kLaneCh - 1) / kLaneCh);
  if (is_bf16) {
    tshift_position_partial_kernel<__nv_bfloat16><<<grid1, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(ypos),
        static_cast<float*>(partial), t_in, t_out, v, c, stride, offset, rows,
        rows_per_chunk);
  } else {
    tshift_position_partial_kernel<float><<<grid1, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(ypos), static_cast<float*>(partial), t_in,
        t_out, v, c, stride, offset, rows, rows_per_chunk);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tshift_position_final_kernel<<<(c + kLaneCh - 1) / kLaneCh, block, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), chunks, c,
      static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}
