// Fused spatial Shift-GCN transform, forward (eval path).
//
// Replaces the Pallas TPU kernel of the reference package,
// ops/pallas/shift_gcn_kernel.py::_fwd_kernel (reached through
// fused_shift_gcn / _run_fwd).  For x (R, V, C), gate (V, C), W (C, D),
// bias (D):
//
//   h[r, u, c]   = x[r, (u + c) % V, c] * gate[u, c]       (shear in, gate)
//   z[r, u, d]   = sum_c h[r, u, c] * W[c, d] + bias[d]
//   out[r, w, d] = z[r, (w - d) % V, d]                     (shear out)
//
// fp32 accumulation; x and out are fp32 or bf16, gate/W/bias fp32.
//
// Bound on the H100: operations in fp32.  2*R*V*C*D flops against
// (R*V*C + R*V*D) activations moved: at C, D >= 64 that is more than the
// fp32 SIMT rate (67 TFLOP/s) can do in the time 3.35 TB/s moves the bytes.
// Both shears wrap around the joint axis, so a block owns whole frames:
// kFrames = kRows / V frames (4 at V=33) and a 64-column tile of D.  The
// design keeps every intermediate on chip:
//   - the gather-load reads the block's x slab in its own order (coalesced
//     over C) and scatters each value, times the gate of its destination
//     joint, into shared memory at its sheared row;
//   - a register-tiled SIMT product (each thread 10 rows x 4 columns)
//     accumulates over C in 32-channel steps; C need not be a multiple of
//     anything (C=3 in the first layer);
//   - bias is added in registers, the tile is staged in shared memory, and
//     the out-shear is folded into the store, which writes each output row
//     contiguously.
// The reference kernel's log2(V) roll decomposition was a workaround for
// the TPU compiler and has no counterpart here.  Tensor cores (mma.sync or
// wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 16 x 16
constexpr int kRows = 160;           // frames * V rows per block, at most
constexpr int kCols = 64;            // output columns per block
constexpr int kK = 32;               // input channels per step
constexpr int kTM = kRows / 16;      // rows per thread
constexpr int kTN = kCols / 16;      // columns per thread
constexpr int kStageFloats = kRows * kK + kK * kCols;
constexpr int kOutFloats = kRows * kCols;
constexpr int kSmemFloats = kStageFloats > kOutFloats ? kStageFloats
                                                      : kOutFloats;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int wrap(int a, int v) {
  const int m = a % v;
  return m < 0 ? m + v : m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shift_gcn_kernel(const T* __restrict__ x, const float* __restrict__ gate,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 T* __restrict__ out, int r_total, int v, int c, int d,
                 int frames) {
  __shared__ __align__(16) float smem[kSmemFloats];
  float* hs = smem;                   // [kRows][kK]   sheared, gated x
  float* ws = smem + kRows * kK;      // [kK][kCols]   W tile
  float* zs = smem;                   // [kRows][kCols] epilogue (aliases)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int r0 = blockIdx.x * frames;
  const int d0 = blockIdx.y * kCols;
  const int nf = min(frames, r_total - r0);  // frames present in this block
  const int rows = nf * v;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < c; k0 += kK) {
    // gather-load: source element (r, src, ch) lands at sheared row
    // u = (src - ch) mod V, scaled by gate[u, ch]
    for (int l = tid; l < rows * kK; l += kThreads) {
      const int kk = l % kK;
      const int m_src = l / kK;
      const int r = m_src / v;
      const int src = m_src - r * v;
      const int ch = k0 + kk;
      const int u = wrap(src - ch, v);
      float val = 0.0f;
      if (ch < c) {
        val = load_f(x + (static_cast<int64_t>(r0) * v + m_src) * c + ch) *
              gate[u * c + ch];
      }
      hs[(r * v + u) * kK + kk] = val;
    }
    for (int l = tid; l < kK * kCols; l += kThreads) {
      const int kk = l / kCols;
      const int col = l % kCols;
      const int ch = k0 + kk;
      const int dd = d0 + col;
      ws[l] = (ch < c && dd < d) ? w[static_cast<int64_t>(ch) * d + dd]
                                 : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(ws + kk * kCols +
                                                        tx * kTN);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float a = hs[(ty + 16 * i) * kK + kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  // bias in registers, stage z, then store with the out-shear folded in
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int dd = d0 + tx * kTN + j;
      zs[m * kCols + tx * kTN + j] = acc[i][j] + (dd < d ? bias[dd] : 0.0f);
    }
  }
  __syncthreads();
  for (int l = tid; l < rows * kCols; l += kThreads) {
    const int col = l % kCols;
    const int m_out = l / kCols;
    const int dd = d0 + col;
    if (dd >= d) continue;
    const int r = m_out / v;
    const int wj = m_out - r * v;
    const int u = wrap(wj - dd, v);
    store_f(out + (static_cast<int64_t>(r0) * v + m_out) * d + dd,
            zs[(r * v + u) * kCols + col]);
  }
}

}  // namespace

extern "C" int shift_gcn_forward(const void* x, const void* gate,
                                 const void* w, const void* bias, void* out,
                                 int r, int v, int c, int d, int is_bf16,
                                 void* stream) {
  if (v < 1 || v > kRows) return static_cast<int>(cudaErrorInvalidValue);
  if (r == 0 || c == 0 || d == 0) return 0;
  const int frames = kRows / v;
  const dim3 grid((r + frames - 1) / frames, (d + kCols - 1) / kCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    shift_gcn_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gate),
        static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), r, v, c, d, frames);
  } else {
    shift_gcn_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gate),
        static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<float*>(out), r, v, c, d, frames);
  }
  return static_cast<int>(cudaGetLastError());
}
