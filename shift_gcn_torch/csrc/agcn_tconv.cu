// 2s-AGCN's 9-tap temporal convolution: forward, input gradient and the
// weight and bias gradients.
//
// Replaces no Pallas kernel: the reference package leaves its temporal
// convolutions to XLA.  The port's ``agcn2s`` family (models/agcn.py,
// the published 2s-AGCN of Shi et al., CVPR 2019) ends every unit with a
// (9 x 1) convolution at temporal stride s = 1 or 2 (units 5 and 8),
// zero-padded by 4 frames.  The model keeps a unit's activations as
// (N', V, T, C), channels last, so the convolution's input is R = N'V
// rows of T frames of C_in channels, each row's frames contiguous:
//
//   y[r, t, co] = b[co] + sum_{k<9} sum_ci x[r, s*t + k - 4, ci] W[co, ci, k]
//
// with T_out = ceil(T / s).  cuDNN ran it on a (R, C, T, 1) view of that
// layout at ~35% of the fp32 SIMT rate.  These kernels keep the one fact
// that layout hides: every input frame serves nine taps.
//
// What bounds it.  The ten published convolutions do 1.557 TFLOP forward
// at batch 64 (N' = 128) and as much again for each gradient, and move
// ~16 GB a step: compute-bound.  The products run on the tensor cores at
// fp32 accuracy: 3xTF32 mma.sync (each operand split into a TF32 big
// and small part, small*big + big*small + big*big, fp32 accumulation;
// 495 / 3 = 165 TFLOP/s), as K4-K6 do (csrc/shift_gcn.cu).  mma.sync and
// not wgmma: its fragments load from any shared-memory row, so a tap is
// a shift of the row index into one staged window; wgmma reads B from
// shared memory in its own tiled layout, which a shifted window of rows
// does not have.  No single-pass TF32: one TF32 product keeps ~3 decimal
// digits and misses the fp32 tolerance.
//
// The tensor cores' fp32 accumulator drops the low bits of each sum
// (biased toward zero; csrc/shift_gcn.cu's K6 note): over the 9 * C_in
// products of a 256-channel output (864 accumulations) that reaches
// ~2.3e-5 of the largest output.  So every k8 step's three products are
// summed from zero and added to the fp32 accumulators with a rounded
// add (~1e-6 of the largest output, in a simulation of both).
//
// Forward and input gradient (one body, agcn_tconv_forward_kernel and
// agcn_tconv_backward_data_kernel): an implicit GEMM whose rows are
// positions u = (r, j) of a padded timeline.  Each source row r is laid
// out in "q space", q = r * P + pad + f for source frame f, with `pad`
// zero frames on each side (P = T_src + 2 pad), so that a position's tap
// d reads q(u) + d, and q(u) = r * P + s_src * j:
//   forward          source x, s_src = s, pad 4, taps d = k = 0..8,
//                    B_k[ci][co] = W[co, ci, k]; out frame j;
//   input grad s=1   source dy, s_src 1, pad 4, taps d = 0..8, k = 8 - d,
//                    B_k[co][ci] = W[co, ci, k]; out frame j;
//   input grad s=2   source dy, s_src 1, pad 2; position j feeds out
//                    frames 2j (parity 0: d = 0..4, k = 8 - 2d) and
//                    2j + 1 (parity 1: d = 1..4, k = 9 - 2d).
// A block takes `bu` consecutive positions (crossing rows freely: the
// padding frames between rows are staged as zeros) by BN output channels
// (64 or 128).  For each chunk of 16 source channels it stages the
// window of q that its positions' nine taps read ONCE: 16-byte cp.async
// of the raw rows, then one pass that splits each element into its TF32
// big and small halves, stored as pairs.  All nine taps (five per parity
// for the strided input gradient, which stages one dy window for both)
// read their A fragments from that one slab at row offset d.  B, the
// weights, is split and laid out in fragment order once per call by a
// pack kernel (agcn_tconv_*_pack_kernel), and each (chunk, tap) step's
// B tile streams through a 3-stage cp.async ring.  16 warps, each a 64
// positions x 32 channels tile: a k8 step loads 4 A fragments (16
// 8-byte loads) and 4 B fragments (4 16-byte loads) for 48 mma.  The
// slab's row stride (20 pairs, or 18 where s_src = 2) keeps the
// shifted 8-byte fragment loads free of bank conflicts.  The epilogue
// adds the bias (forward) and stores from the accumulators, two
// channels a lane; the strided input gradient writes every other frame.
//
// Weight gradient (agcn_tconv_backward_weight_kernel + ..._final_kernel):
//   dW[co, ci, k] = sum_{r,t} dy[r, t, co] x[r, s t + k - 4, ci],
//   db[co]        = sum_{r,t} dy[r, t, co].
// A block (ci tile of 32, co tile of 64, split z) walks groups of 8
// rows and stages of 15 output frames: the x window (8 rows x (14 s + 9)
// frames x 32 channels, split into TF32 pairs once as it is staged) and
// dy (8 rows x 15 frames x 64 channels, raw), and accumulates all nine
// taps of its (64 x 32) tile from them: M = co, N = ci, K = the 8 rows
// of one output frame, tap k reading the x window at frame s p + k.
// Warp w holds co rows 32 (w % 2) .. + 32 and ci columns 8 (w / 2) .. + 8
// for the nine taps (72 accumulators).  Blocks of ci tile 0 also sum db
// from the staged dy.  Each split writes its partial (dW, db) to scratch,
// and the final kernel sums the splits in order: no float atomics, so
// two launches are bit-equal.  The splits are chosen by ops/agcn_tconv.py
// from the shapes alone (~528 blocks, two an SM), which keeps the
// scratch under ~40 MB at every published width.
//
// Limits (ops/agcn_tconv.py refuses others before launching): fp32;
// C_in and C_out multiples of 4 (16-byte rows); a 9-tap kernel; stride
// 1, or 2 with T even; the forward's and input gradient's shared memory
// within the card's 227 KB (the wrapper shrinks `bu` where short rows
// make the window's padding large).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;   // forward and input gradient: 16 warps
constexpr int kWgThreads = 256; // weight gradient: 8 warps
constexpr int kCK = 16;        // source channels a chunk: two k8 steps
constexpr int kStages = 3;     // B ring depth
constexpr int kTaps = 9;

// weight gradient
constexpr int kWgCo = 64;      // co tile
constexpr int kWgCi = 32;      // ci tile
constexpr int kWgRows = 8;     // rows of a group: the mma's k
constexpr int kWgFrames = 15;  // output frames a stage (divides 75, 150, 300)
constexpr int kWgFinalThreads = 256;

// TF32 rounding to nearest, ties away from zero (cvt.rna.tf32.f32), on
// the integer pipe, as csrc/shift_gcn.cu does
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(a);
  small = tf32_rna(a - __uint_as_float(big));
}
// D += A B.  Not volatile: the products have no side effects, so the
// compiler may interleave independent ones and hide each one's latency.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// D = A B, from zero
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  const float z = 0.0f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(z));
}
// The 3xTF32 products of one k8 step for kN tiles that share their A
// fragment (big ab, small as), each summed from zero (small*big,
// big*small, then big*big) and added to its fp32 accumulator rounded.
// The three passes run over all kN tiles in turn, so that consecutive
// products are independent.  b[j] = {big b0, big b1, small b0, small b1}.
template <int kN>
__device__ __forceinline__ void mma_3x_add(float (*acc)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint4 (&b)[kN]) {
  float d[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j) mma_tf32_zero(d[j], as, b[j].x, b[j].y);
#pragma unroll
  for (int j = 0; j < kN; ++j) mma_tf32(d[j], ab, b[j].z, b[j].w);
#pragma unroll
  for (int j = 0; j < kN; ++j) mma_tf32(d[j], ab, b[j].x, b[j].y);
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += d[j][e];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ---------------------------------------------------------------------------
// Forward and input gradient
// ---------------------------------------------------------------------------

struct ConvArgs {
  const float* src;     // (rows, ts, kdim): x, or dy
  const uint4* pack;    // B fragments, see pack_body
  const float* bias;    // (ndim,) forward; null for the input gradient
  float* out;           // (rows, tout, ndim)
  int rows;             // R = N'V
  int ts;               // source frames a row
  int tu;               // positions a row
  int tout;             // output frames a row
  int kdim;             // source channels
  int ndim;             // output channels
  int period;           // P = ts + 2 pad: q-space frames a row
  int pad;              // zero frames before a row's first (4, or 2)
  int sstride;          // source frames a position (s forward, else 1)
  int taps;             // tap steps a chunk (9, or 5 for parity pairs)
  int npar;             // output parities (2: the strided input gradient)
  int chunks;           // ceil(kdim / kCK)
  int nt8;              // n8 tiles of the pack (a multiple of BN / 8)
  int bu;               // positions a block (a multiple of 64)
  int slab_rows;        // the largest window a block stages, q rows
  int ld;               // slab row stride, pairs (20, or 18)
};

// B fragments: for step d, parity p, chunk c, n8 tile n, k8 step kk and
// lane (g, t): {big b0, big b1, small b0, small b1} with b0 = B[c*16 +
// kk*8 + t][n*8 + g], b1 four rows down; taps past the kernel and
// channels past kdim / ndim are zeros.  kForward: B_k[ci][co] = W[co, ci,
// k], k = d; otherwise B_k[co][ci] = W[co, ci, k], k = 8 - d (npar 1) or
// 8 + p - 2d (npar 2).
__device__ __forceinline__ void pack_body(const float* __restrict__ w,
                                          uint4* __restrict__ pack,
                                          bool forward, int cin, int cout,
                                          int taps, int npar, int chunks,
                                          int nt8) {
  const int kdim = forward ? cin : cout, ndim = forward ? cout : cin;
  const int64_t total = (int64_t)taps * npar * chunks * nt8 * 64;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int lane = (int)(e & 31);
  const int kk = (int)((e >> 5) & 1);
  int64_t rest = e >> 6;
  const int n8 = (int)(rest % nt8);
  rest /= nt8;
  const int c = (int)(rest % chunks);
  rest /= chunks;
  const int p = (int)(rest % npar);
  const int d = (int)(rest / npar);
  const int k = forward ? d : (npar == 1 ? 8 - d : 8 + p - 2 * d);
  const int n = n8 * 8 + (lane >> 2);
  const int kr = c * kCK + kk * 8 + (lane & 3);
  float v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kr + 4 * h;
    float val = 0.0f;
    if (k >= 0 && k < kTaps && row < kdim && n < ndim)
      val = forward ? w[((size_t)n * cin + row) * kTaps + k]
                    : w[((size_t)row * cin + n) * kTaps + k];
    v[h] = val;
  }
  uint4 q;
  split(v[0], q.x, q.z);
  split(v[1], q.y, q.w);
  pack[e] = q;
}

__global__ void agcn_tconv_forward_pack_kernel(const float* __restrict__ w,
                                               uint4* __restrict__ pack,
                                               int cin, int cout, int taps,
                                               int npar, int chunks,
                                               int nt8) {
  pack_body(w, pack, true, cin, cout, taps, npar, chunks, nt8);
}

__global__ void agcn_tconv_backward_pack_kernel(const float* __restrict__ w,
                                                uint4* __restrict__ pack,
                                                int cin, int cout, int taps,
                                                int npar, int chunks,
                                                int nt8) {
  pack_body(w, pack, false, cin, cout, taps, npar, chunks, nt8);
}

__host__ __device__ constexpr int raw_bytes(int slab_rows) {
  return slab_rows * kCK * 4;
}

template <int kBN>
__device__ __forceinline__ void conv_body(const ConvArgs& a) {
  constexpr int kWarpsN = kBN / 32;  // warps of 64 positions x 32 channels
  constexpr int kWarpsM = 16 / kWarpsN;
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* slab = reinterpret_cast<uint2*>(smem);
  float* raw = reinterpret_cast<float*>(smem + (size_t)a.slab_rows * a.ld * 8);
  uint4* ring = reinterpret_cast<uint4*>(smem + (size_t)a.slab_rows * a.ld * 8 +
                                         raw_bytes(a.slab_rows));
  const int stage_vecs = a.npar * kBN * 8;  // uint4 a ring stage

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % kWarpsN, wm = warp / kWarpsN;
  const int per_par = kWarpsM / a.npar;  // warps of one parity
  const int par = wm / per_par;
  const int wmp = wm % per_par;
  const bool active = wmp * 64 < a.bu;

  const int64_t total = (int64_t)a.rows * a.tu;
  const int64_t u0 = (int64_t)blockIdx.x * a.bu;
  const int n0 = blockIdx.y * kBN;
  const int dmax = a.npar == 2 ? 4 : 8;
  auto qof = [&](int64_t u) {
    return (u / a.tu) * a.period + (int64_t)a.sstride * (u % a.tu);
  };
  const int64_t q_lo = qof(u0);
  const int64_t u_last = (u0 + a.bu < total ? u0 + a.bu : total) - 1;
  const int rows = (int)(qof(u_last) + dmax + 1 - q_lo);

  // this lane's A rows: positions u0 + wmp*64 + 16 i + g + 8 h, as slab
  // offsets in pairs; a position past the end reads row 0 and is dropped
  int off[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t u = u0 + wmp * 64 + 16 * i + g + 8 * h;
      off[i][h] = u < total ? (int)(qof(u) - q_lo) * a.ld : 0;
    }

  const int steps = a.chunks * a.taps;
  // copy step p's B tile, and at a chunk's first step its raw window
  auto fetch = [&](int p) {
    const int c = p / a.taps, d = p % a.taps;
    uint4* dst = ring + (p % kStages) * stage_vecs;
    for (int l = tid; l < stage_vecs; l += kThreads) {
      const int pp = l / (kBN * 8), r = l % (kBN * 8);
      const uint4* src = a.pack +
          (((int64_t)(d * a.npar + pp) * a.chunks + c) * a.nt8 + n0 / 8) * 64 +
          r;
      cp_async16(dst + l, src, true);
    }
    if (d == 0) {
      for (int l = tid; l < rows * 4; l += kThreads) {
        const int row = l >> 2, part = l & 3;
        const int64_t q = q_lo + row;
        const int64_t r = q / a.period;
        const int f = (int)(q - r * a.period) - a.pad;
        const int ch = c * kCK + part * 4;
        const bool in = r < a.rows && f >= 0 && f < a.ts && ch < a.kdim;
        const float* s =
            in ? a.src + ((int64_t)r * a.ts + f) * a.kdim + ch : a.src;
        cp_async16(raw + row * kCK + part * 4, s, in);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) fetch(s);
    cp_async_commit();
  }
  for (int p = 0; p < steps; ++p) {
    const int c = p / a.taps, d = p % a.taps;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step p landed; every warp is done with step p - 1
    if (d == 0) {
      // split the chunk's window once: pairs {big, small} a channel
      for (int l = tid; l < rows * 4; l += kThreads) {
        const int row = l >> 2, part = l & 3;
        const float4 v =
            *reinterpret_cast<const float4*>(raw + row * kCK + part * 4);
        uint4 lo, hi;
        split(v.x, lo.x, lo.y);
        split(v.y, lo.z, lo.w);
        split(v.z, hi.x, hi.y);
        split(v.w, hi.z, hi.w);
        uint4* dst = reinterpret_cast<uint4*>(slab + row * a.ld + part * 4);
        dst[0] = lo;
        dst[1] = hi;
      }
      __syncthreads();
    }
    if (p + kStages - 1 < steps) fetch(p + kStages - 1);
    cp_async_commit();

    // parity 1 has no tap at d = 0
    if (!active || (par == 1 && d == 0)) continue;
    const uint4* bs = ring + (p % kStages) * stage_vecs + par * kBN * 8 +
                      wn * 4 * 64 + lane;
    const int dofs = d * a.ld;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (c * kCK + kk * 8 >= a.kdim) break;  // zeros past the channels
      uint4 bq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bq[j] = bs[(j * 2 + kk) * 32];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = dofs + kk * 8 + t;
        const uint2 x0 = slab[off[i][0] + col];
        const uint2 x1 = slab[off[i][1] + col];
        const uint2 x2 = slab[off[i][0] + col + 4];
        const uint2 x3 = slab[off[i][1] + col + 4];
        const uint32_t ab[4] = {x0.x, x1.x, x2.x, x3.x};
        const uint32_t as[4] = {x0.y, x1.y, x2.y, x3.y};
        mma_3x_add<4>(acc[i], ab, as, bq);
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  // epilogue: two channels a lane and row
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + 2 * t;
    if (col >= a.ndim) continue;
    float b0 = 0.0f, b1 = 0.0f;
    if (a.bias != nullptr) {
      b0 = a.bias[col];
      b1 = a.bias[col + 1];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t u = u0 + wmp * 64 + 16 * i + g + 8 * h;
        if (u >= total) continue;
        int64_t orow = u;
        if (a.npar == 2) {
          const int64_t r = u / a.tu;
          orow = r * a.tout + 2 * (u - r * a.tu) + par;
        }
        *reinterpret_cast<float2*>(a.out + orow * a.ndim + col) =
            make_float2(acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
      }
  }
}

template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    agcn_tconv_forward_kernel(const ConvArgs a) {
  conv_body<kBN>(a);
}

template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    agcn_tconv_backward_data_kernel(const ConvArgs a) {
  conv_body<kBN>(a);
}

// ---------------------------------------------------------------------------
// Weight gradient
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int wg_window(int stride) {
  return stride * (kWgFrames - 1) + kTaps;
}
// row strides: x pairs, 4 mod 16 (8-byte fragment loads of rows t);
// dy floats, 8 mod 32 (4-byte loads of rows t)
__host__ __device__ constexpr int wg_ldx(int stride) {
  return wg_window(stride) * kWgCi + 4;
}
constexpr int kWgLdy = kWgFrames * kWgCo + 8;
__host__ __device__ constexpr int wg_smem(int stride) {
  return kWgRows * wg_ldx(stride) * 8 + kWgRows * kWgLdy * 4;
}

__global__ void __launch_bounds__(kWgThreads, 2)
    agcn_tconv_backward_weight_kernel(
        const float* __restrict__ x, const float* __restrict__ dy,
        float* __restrict__ partial, float* __restrict__ partial_db,
        int rows, int tx, int ty, int cin, int cout, int stride,
        int groups_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = wg_ldx(stride);
  uint2* xs = reinterpret_cast<uint2*>(smem);
  float* ys = reinterpret_cast<float*>(smem + kWgRows * ldx * 8);
  const int window = wg_window(stride);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ci0 = blockIdx.x * kWgCi, co0 = blockIdx.y * kWgCo;
  const int z = blockIdx.z;
  const int co_l = 32 * (warp & 1), ci_l = 8 * (warp >> 1);
  const bool sums_db = blockIdx.x == 0 && tid < kWgCo;
  const int groups = (rows + kWgRows - 1) / kWgRows;
  const int gr0 = z * groups_per_split;
  const int gr1 = min(groups, gr0 + groups_per_split);

  float acc[2][kTaps][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][k][e] = 0.0f;
  float db = 0.0f;

  for (int gr = gr0; gr < gr1; ++gr) {
    const int r0 = gr * kWgRows;
    for (int f0 = 0; f0 < ty; f0 += kWgFrames) {
      const int nf = min(kWgFrames, ty - f0);
      __syncthreads();  // the last stage's reads are done
      // x window: frames s f0 - 4 + ff, split into pairs as staged
      for (int l = tid; l < kWgRows * window * (kWgCi / 4);
           l += kWgThreads) {
        const int part = l % (kWgCi / 4);
        int rest = l / (kWgCi / 4);
        const int ff = rest % window;
        const int row = rest / window;
        const int r = r0 + row, f = stride * f0 - 4 + ff;
        const int ci = ci0 + part * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < rows && f >= 0 && f < tx && ci < cin)
          v = __ldg(reinterpret_cast<const float4*>(
              x + ((int64_t)r * tx + f) * cin + ci));
        uint4 lo, hi;
        split(v.x, lo.x, lo.y);
        split(v.y, lo.z, lo.w);
        split(v.z, hi.x, hi.y);
        split(v.w, hi.z, hi.w);
        uint4* dst = reinterpret_cast<uint4*>(xs + row * ldx + ff * kWgCi +
                                              part * 4);
        dst[0] = lo;
        dst[1] = hi;
      }
      // dy: frames f0 .. f0 + 14, raw
      for (int l = tid; l < kWgRows * kWgFrames * (kWgCo / 4);
           l += kWgThreads) {
        const int part = l % (kWgCo / 4);
        int rest = l / (kWgCo / 4);
        const int p = rest % kWgFrames;
        const int row = rest / kWgFrames;
        const int r = r0 + row, f = f0 + p;
        const int co = co0 + part * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < rows && f < ty && co < cout)
          v = __ldg(reinterpret_cast<const float4*>(
              dy + ((int64_t)r * ty + f) * cout + co));
        *reinterpret_cast<float4*>(ys + row * kWgLdy + p * kWgCo +
                                   part * 4) = v;
      }
      __syncthreads();
      if (sums_db) {
        for (int row = 0; row < kWgRows; ++row)
          for (int p = 0; p < nf; ++p)
            db += ys[row * kWgLdy + p * kWgCo + tid];
      }
      for (int p = 0; p < nf; ++p) {
        // A = dy^T: rows co, k the 8 rows of frame p
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* y0 = ys + t * kWgLdy + p * kWgCo + co_l + 16 * m + g;
          const float* y1 = y0 + 4 * kWgLdy;
          split(y0[0], ab[m][0], as[m][0]);
          split(y0[8], ab[m][1], as[m][1]);
          split(y1[0], ab[m][2], as[m][2]);
          split(y1[8], ab[m][3], as[m][3]);
        }
        const uint2* xb = xs + t * ldx + stride * p * kWgCi + ci_l + g;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const uint2 b0 = xb[k * kWgCi];
          const uint2 b1 = xb[4 * ldx + k * kWgCi];
          const uint4 b[1] = {make_uint4(b0.x, b1.x, b0.y, b1.y)};
#pragma unroll
          for (int m = 0; m < 2; ++m)
            mma_3x_add<1>(&acc[m][k], ab[m], as[m], b);
        }
      }
    }
  }

  // the split's partial: partial[z][co][ci][k]
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + co_l + 16 * m + g + 8 * h;
      if (co >= cout) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ci = ci0 + ci_l + 2 * t + e;
        if (ci >= cin) continue;
        float* dst = partial + (((int64_t)z * cout + co) * cin + ci) * kTaps;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) dst[k] = acc[m][k][2 * h + e];
      }
    }
  if (sums_db && co0 + tid < cout)
    partial_db[(int64_t)z * cout + co0 + tid] = db;
}

__global__ void agcn_tconv_backward_weight_final_kernel(
    const float* __restrict__ partial, const float* __restrict__ partial_db,
    float* __restrict__ dw, float* __restrict__ dbias, int splits,
    int cin, int cout) {
  const int64_t nw = (int64_t)cout * cin * kTaps;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < nw) {
    float sum = 0.0f;
    for (int z = 0; z < splits; ++z) sum += partial[z * nw + e];
    dw[e] = sum;
  } else if (e < nw + cout) {
    const int co = (int)(e - nw);
    float sum = 0.0f;
    for (int z = 0; z < splits; ++z) sum += partial_db[(int64_t)z * cout + co];
    dbias[co] = sum;
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// dynamic shared memory of a forward or input-gradient block, bytes: the
// split window, the raw window and the B ring
int conv_smem(int slab_rows, int ld, int npar, int bn) {
  return slab_rows * ld * 8 + raw_bytes(slab_rows) +
         kStages * npar * bn * 8 * 16;
}

}  // namespace

extern "C" {

// Forward (backward = 0) or input gradient (backward = 1) of the 9-tap
// conv: w (cout, cin, 9, 1) is packed into `pack` (taps * npar * chunks
// * nt8 * 64 uint4), then src (rows, ts, kdim) -> out (rows, tout,
// ndim); the plan (ops/agcn_tconv.py) gives the q-space layout, the
// positions a block and the window's rows.
int agcn_tconv_run(int backward, const float* src, const float* w,
                   const float* bias, void* pack, float* out, int rows,
                   int ts, int tu, int tout, int kdim, int ndim, int cin,
                   int cout, int period, int pad, int sstride, int taps,
                   int npar, int chunks, int nt8, int bu, int slab_rows,
                   int ld, int bn, cudaStream_t stream) {
  const int64_t pack_vecs = (int64_t)taps * npar * chunks * nt8 * 64;
  const int pack_blocks = (int)((pack_vecs + 255) / 256);
  if (backward)
    agcn_tconv_backward_pack_kernel<<<pack_blocks, 256, 0, stream>>>(
        w, static_cast<uint4*>(pack), cin, cout, taps, npar, chunks, nt8);
  else
    agcn_tconv_forward_pack_kernel<<<pack_blocks, 256, 0, stream>>>(
        w, static_cast<uint4*>(pack), cin, cout, taps, npar, chunks, nt8);
  int status = (int)cudaGetLastError();
  if (status) return status;
  ConvArgs a{src, static_cast<const uint4*>(pack), bias, out, rows, ts, tu,
             tout, kdim, ndim, period, pad, sstride, taps, npar, chunks,
             nt8, bu, slab_rows, ld};
  const int64_t total = (int64_t)rows * tu;
  const dim3 grid((unsigned)((total + bu - 1) / bu),
                  (unsigned)((ndim + bn - 1) / bn));
  const size_t smem = conv_smem(slab_rows, ld, npar, bn);
  const void* kernel;
  if (bn == 64)
    kernel = backward ? (const void*)agcn_tconv_backward_data_kernel<64>
                      : (const void*)agcn_tconv_forward_kernel<64>;
  else
    kernel = backward ? (const void*)agcn_tconv_backward_data_kernel<128>
                      : (const void*)agcn_tconv_forward_kernel<128>;
  status = set_smem(kernel, smem);
  if (status) return status;
  if (bn == 64) {
    if (backward)
      agcn_tconv_backward_data_kernel<64><<<grid, kThreads, smem, stream>>>(a);
    else
      agcn_tconv_forward_kernel<64><<<grid, kThreads, smem, stream>>>(a);
  } else {
    if (backward)
      agcn_tconv_backward_data_kernel<128><<<grid, kThreads, smem, stream>>>(a);
    else
      agcn_tconv_forward_kernel<128><<<grid, kThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// dW (cout, cin, 9, 1) and db (cout,) from x (rows, tx, cin) and dy
// (rows, ty, cout); partial: splits * (cout * cin * 9 + cout) floats.
int agcn_tconv_weight(const float* x, const float* dy, float* partial,
                      float* dw, float* dbias, int rows, int tx, int ty,
                      int cin, int cout, int stride, int splits,
                      int groups_per_split, cudaStream_t stream) {
  const size_t smem = wg_smem(stride);
  int status =
      set_smem((const void*)agcn_tconv_backward_weight_kernel, smem);
  if (status) return status;
  const dim3 grid((cin + kWgCi - 1) / kWgCi, (cout + kWgCo - 1) / kWgCo,
                  splits);
  float* partial_db = partial + (int64_t)splits * cout * cin * kTaps;
  agcn_tconv_backward_weight_kernel<<<grid, kWgThreads, smem, stream>>>(
      x, dy, partial, partial_db, rows, tx, ty, cin, cout, stride,
      groups_per_split);
  status = (int)cudaGetLastError();
  if (status) return status;
  const int64_t n = (int64_t)cout * cin * kTaps + cout;
  agcn_tconv_backward_weight_final_kernel<<<
      (unsigned)((n + kWgFinalThreads - 1) / kWgFinalThreads),
      kWgFinalThreads, 0, stream>>>(partial, partial_db, dw, dbias, splits,
                                    cin, cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
