// Fused spatial Shift-GCN transform: forward (K4), input gradient (K5)
// and the shear recompute of the weight gradients (K6).
//
// Replaces the Pallas TPU kernels of the reference package,
// ops/pallas/shift_gcn_kernel.py: _fwd_kernel reached through
// fused_shift_gcn / _run_fwd (K4), the same kernel reached through
// _run_dx for the input gradient (K5), and _shear_gate_kernel reached
// through _run_shear_gate from the backward (K6).  For x (R, V, C),
// gate (V, C), W (C, D), bias (D):
//
//   h[r, u, c]   = x[r, (u + c) % V, c] * gate[u, c]       (shear in, gate)
//   z[r, u, d]   = sum_c h[r, u, c] * W[c, d] + bias[d]
//   out[r, w, d] = z[r, (w - d) % V, d]                     (shear out)
//
// K5, for the cotangent g (R, V, D):
//
//   dz[r, u, c]  = sum_d g[r, (u + d) % V, d] * W[c, d]
//   dx[r, w, c]  = dz[r, u, c] * gate[u, c],  u = (w - c) % V
//
// K6: out[r, u, c] = x[r, (u + c) % V, c] in fp32.  The reference's
// shear-gate kernel also multiplies by gate[u, c]; here that multiply is
// folded into the weight-gradient reduction over the (V, C, D) per-joint
// product (ops/shift_gcn_kernel.py), so K6 is the bare shear.
//
// fp32 accumulation; x, g and outputs are fp32 or bf16, gate/W/bias fp32.
//
// Bound on the H100: K4 and K5 by operations in fp32, 2*R*V*C*D flops
// against (R*V*C + R*V*D) activations moved: at C, D >= 64 that is more
// than the fp32 SIMT rate (67 TFLOP/s) can do in the time 3.35 TB/s moves
// the bytes.  K6 by memory: one load and one store per element.
//
// K4/K5 design (one template; K5 is its kDx instantiation): both shears
// wrap around the joint axis, so a block owns whole frames: kFrames =
// kRows / V frames (4 at V=33) and a 64-column tile of the output
// channels.  Every intermediate stays on chip:
//   - the gather-load reads the block's input slab in its own order
//     (coalesced over channels) and scatters each value, times the gate
//     of its destination joint (K4 only), into shared memory at its
//     sheared row;
//   - a register-tiled SIMT product (each thread 10 rows x 4 columns)
//     accumulates in 32-channel steps; channel counts need not be a
//     multiple of anything (C=3 in the first layer).  K5 reads W
//     transposed from the (C, D) array as it stages the tile, so no
//     transposed copy is made;
//   - K4 adds the bias in registers; the tile is staged in shared memory
//     and the out-shear is folded into the store, which writes each
//     output row contiguously.  K5 multiplies by the gate of the source
//     joint u at that store, which is the reference's shear_out(gate)
//     out_gate.
// The reference kernel's log2(V) roll decomposition was a workaround for
// the TPU compiler and has no counterpart here.  Tensor cores (mma.sync or
// wgmma) are later work.
//
// K6 design: one thread per output element, grid-stride; the output is
// written in order (coalesced), the sheared read stays inside one frame
// (V*C elements, cache-resident).  The output is fp32 for fp32 or bf16
// input: it feeds the weight-gradient products, which run in fp32.

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

// kDx=false: K4, x (R, V, c), w (c, d) row-major, gate on the input side,
// bias added.  kDx=true: K5, x is the cotangent (R, V, c) with c = D of
// the forward, w is the forward's (d, c) array read transposed, gate (V, d)
// multiplies the output at its source joint, no bias.
template <typename T, bool kDx>
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
        val = load_f(x + (static_cast<int64_t>(r0) * v + m_src) * c + ch);
        if (!kDx) val *= gate[u * c + ch];
      }
      hs[(r * v + u) * kK + kk] = val;
    }
    for (int l = tid; l < kK * kCols; l += kThreads) {
      const int kk = l / kCols;
      const int col = l % kCols;
      const int ch = k0 + kk;
      const int dd = d0 + col;
      float wv = 0.0f;
      if (ch < c && dd < d) {
        wv = kDx ? w[static_cast<int64_t>(dd) * c + ch]
                 : w[static_cast<int64_t>(ch) * d + dd];
      }
      ws[l] = wv;
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
      zs[m * kCols + tx * kTN + j] =
          acc[i][j] + ((!kDx && dd < d) ? bias[dd] : 0.0f);
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
    float val = zs[(r * v + u) * kCols + col];
    if (kDx) val *= gate[u * d + dd];
    store_f(out + (static_cast<int64_t>(r0) * v + m_out) * d + dd, val);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shear_in_kernel(const T* __restrict__ x, float* __restrict__ out,
                int64_t total, int v, int c) {
  const int64_t vc = static_cast<int64_t>(v) * c;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t frame = i / vc;
    const int uc = static_cast<int>(i - frame * vc);
    const int u = uc / c;
    const int ch = uc - u * c;
    out[i] = load_f(x + frame * vc + static_cast<int64_t>((u + ch) % v) * c +
                    ch);
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
    shift_gcn_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gate),
        static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), r, v, c, d, frames);
  } else {
    shift_gcn_kernel<float, false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gate),
        static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<float*>(out), r, v, c, d, frames);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: dx (r, v, c) from the cotangent g (r, v, d), the forward's gate
// (v, c) and W (c, d).
extern "C" int shift_gcn_dx(const void* g, const void* gate, const void* w,
                            void* dx, int r, int v, int c, int d,
                            int is_bf16, void* stream) {
  if (v < 1 || v > kRows) return static_cast<int>(cudaErrorInvalidValue);
  if (r == 0 || c == 0 || d == 0) return 0;
  const int frames = kRows / v;
  const dim3 grid((r + frames - 1) / frames, (c + kCols - 1) / kCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    shift_gcn_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(gate),
        static_cast<const float*>(w), nullptr,
        static_cast<__nv_bfloat16*>(dx), r, v, d, c, frames);
  } else {
    shift_gcn_kernel<float, true><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(gate),
        static_cast<const float*>(w), nullptr, static_cast<float*>(dx), r, v,
        d, c, frames);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6: out (r, v, c) fp32 = shear_in(x).
extern "C" int shear_in(const void* x, void* out, int r, int v, int c,
                        int is_bf16, void* stream) {
  const int64_t total = static_cast<int64_t>(r) * v * c;
  if (total == 0) return 0;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (is_bf16) {
    shear_in_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), o, total, v, c);
  } else {
    shear_in_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), o, total, v, c);
  }
  return static_cast<int>(cudaGetLastError());
}
