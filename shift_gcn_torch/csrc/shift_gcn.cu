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
// Bound on the H100.  K4 and K5 do 2*R*V*C*D flops on the tensor cores
// with fp32 accuracy (3xTF32: three TF32 products per multiply-add, so
// 495 / 3 = 165 TFLOP/s) and move (R*V*C + R*V*D) activations once.  The
// larger of the two times is the bound: at the forward's shapes the
// operations term for C, D >= 128 and the bytes term for the narrow
// layers (C=3, and D=64 at bf16 I/O).  K6 is bound by memory: one load
// and one store per element.
//
// K4/K5 design: one template, shift_gcn_mma_kernel<T, kDx, kBN>; K5 is
// its kDx instantiation (A = the cotangent, B = W^T, the gate multiplies
// the output at its source joint, no bias).  A tile is kFrames = kRows / V
// whole frames (4 at V=33: 132 of 144 rows), since both shears wrap
// within a frame, by kBN output channels (128, or 64 where N <= 64).
// Blocks are persistent and walk the tiles, the column tile the faster
// index: one block per SM, two for K5's 64-column tile (80 registers a
// thread; K4's 64-column build spills at 80).  12 warps, 3 along the rows
// by 4 along the columns.  Each 32-channel k-slice goes through:
//   copy    16-byte cp.async of the slab rows as they lie (4 fp32 or 8
//           bf16 per copy), of the W tile and (K4) of the gate slice, into
//           a 2-stage ring that runs across tile boundaries, so the next
//           slice lands while this one is built and multiplied;
//   build   once per block, every A element is sheared, gated (K4) and
//           split, every B element split, into TF32 fragments in shared
//           memory: big = rna(a), small = rna(a - big);
//   mma     mma.sync.m16n8k8 TF32, fp32 accumulation: a_small*b_big +
//           a_big*b_small, then a_big*b_big (3xTF32, error of fp32 order;
//           one TF32 product keeps ~3 decimal digits and misses the fp32
//           tolerance).  bf16 I/O runs the same arithmetic.  A warp holds
//           3 m16 x kBN/32 n8 tiles, its fragments read with 16-byte loads.
// What it does about the five limits of the SIMT template it replaces:
//  1. no tensor cores: 3xTF32 mma.sync as above.  The TF32 rounding is
//     done on the integer pipe (add half an ulp, clear 13 bits: the same
//     value as cvt.rna.tf32.f32, which measured slower).
//  2. division per element, scalar synchronous loads: 16-byte cp.async,
//     double-buffered.  The shear is applied when a fragment is built
//     (row u of frame f, channel c reads slab row f*V + (u + c) mod V,
//     with c mod V taken once per stage and the wrap one compare-and-
//     subtract); each thread's rows are fixed, so their frame and joint are
//     computed once.  The gate is read at the fragment row's own joint u,
//     from the staged [u][k] slice: gate[u, c] * x[(u + c) % V, c] is the
//     product the identity shear_in(x) * gate == shear_in(x *
//     shear_out(gate)) rewrites, with no shear on the gate.  Padded slab
//     rows (36 fp32 / 40 bf16) spread the sheared reads over the banks.
//  3. wasted rows: the 144-row tile is 9 m16 tiles; at V=33 the tile's
//     132 rows use all nine (12 rows of padding, 8%, against 28 of 160
//     before); an m16 tile wholly past the tile's frames is skipped, and
//     so are the column warps past N and the k-steps past C (C=3).
//  4. repeated gathers: the 128-column tile reads the x slab once for
//     D <= 128 and twice for D=256 (four times before), the second time
//     from L2 (the two column tiles run side by side); the A fragments are
//     built once per tile, not once per column warp.
//  5. K5's strided W reads: W's rows are copied with 16-byte cp.async into
//     a [column][k] tile, read as the mma's col-major B fragment.
// Epilogue: K4 adds the bias in registers; z is staged in shared memory
// over the fragment buffer and stored with the out-shear folded in, 16
// bytes along the output channels per thread; K5 multiplies by the gate
// of the source joint there.  Rows that are not a multiple of 16 bytes
// (C=3 at unit 1: K4's input, K5's output) or a misaligned base take
// 4-byte cp.async copies (fp32; bf16 rows are copied by the threads) and
// scalar stores, zero-padded to the k-slice.
// Dynamic shared memory per block: the fragments or the z tile, whichever
// is larger, plus 2 x (slab + W tile + K4's V x 36 gate slice), set with
// cudaFuncSetAttribute at each launch.  At V=33: K4 fp32 161,824 B
// (128-column tile) / 122,656 B (64), bf16 143,392 / 104,224 B; K5 fp32
// 154,368 / 113,152 B, bf16 135,936 / 94,720 B.  Registers a thread
// (nvcc 12.8 for sm_90a; cuobjdump -res-usage, printed by chip_smoke.py):
// K4 160 (128-column tile) / 160 (64; 158 bf16), K5 143 / 80.
// The copy wait, the build, the mma and the epilogue run one after
// another between barriers, each warp in step with the others.  Handing
// the build to producer warps (3 producers for 12 consumers) measured
// slower: the build, not the mma, limits the kernel, so a cheaper build
// comes before any overlap.
//
// K6 design: one thread per output element, grid-stride; the output is
// written in order (coalesced), the sheared read stays inside one frame
// (V*C elements, cache-resident).  The output is fp32 for fp32 or bf16
// input: it feeds the weight-gradient products, which run in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // K6 block
constexpr int kRows = 144;        // frames * V rows per tile, at most
constexpr int kK = 32;            // input channels per pipeline stage
constexpr int kMmaThreads = 384;  // 12 warps: 3 along rows x 4 along columns
constexpr int kWarpsM = 3;
constexpr int kMT = kRows / 16 / kWarpsM;  // m16 tiles per warp (3)
constexpr int kK8 = kK / 8;                // mma k-steps per stage (4)
static_assert(kMmaThreads / 32 == kWarpsM * 4, "warp grid");
static_assert((kMmaThreads / 32) * kMT == kRows / 16 * kK8,
              "the A pass gives each warp kMT (m16, k8) fragment blocks");

// slab row stride in elements: 144 bytes (fp32) or 80 bytes (bf16), a
// multiple of 16 for cp.async; padded so the sheared reads spread banks
template <typename T>
__host__ __device__ constexpr int slab_ld() {
  return sizeof(T) == 4 ? kK + 4 : kK + 8;
}
template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// Shared memory: the fragment region (A big / small, B), which the z tile
// aliases, then a ring of kStages raw stages: the x slab as it lies, the W
// tile (K4 [k][n] with stride kBN + 8, K5 [n][k] with stride kK + 4) and,
// for K4, the gate slice [u][k] with stride kLdg.  kBN output channels per
// tile (128, or 64 for N <= 64), 4 warps along them: kBN / 32 n8 tiles a
// warp.
constexpr int kStages = 2;     // cp.async ring depth
constexpr int kLdg = kK + 4;   // gate slice row stride (fp32)

template <typename T, bool kDx, int kBN>
struct Layout {
  static constexpr int kSlabBytes = kRows * slab_ld<T>() * sizeof(T);
  static constexpr int kWBytes = (kDx ? kBN * (kK + 4) : kK * (kBN + 8)) * 4;
  static constexpr int kFragABytes = kRows / 16 * kK8 * 32 * 16;  // per plane
  static constexpr int kFragBBytes = kBN / 8 * kK8 * 32 * 16;
  static constexpr int kZBytes = kRows * (kBN + 4) * 4;
  static constexpr int kFragBytes = 2 * kFragABytes + kFragBBytes;
  static constexpr int kRegionBytes = kFragBytes > kZBytes ? kFragBytes
                                                           : kZBytes;
  __host__ __device__ static int stage_bytes(int v) {
    return kSlabBytes + kWBytes + (kDx ? 0 : v * kLdg * 4);
  }
  static int bytes(int v) { return kRegionBytes + kStages * stage_bytes(v); }
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// 16 bytes of output: 4 fp32 or 8 bf16
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 q;
  uint32_t* w = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(p) = q;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}
// 4-byte copy for rows that are not a multiple of 16 bytes (fp32 only)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// TF32 rounding to nearest, ties away from zero (cvt.rna.tf32.f32), on
// the integer pipe: add half an ulp of the 10-bit mantissa, clear the 13
// bits below it.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
// a == big + small to about 2^-22 relative, each a TF32 value
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(a);
  small = tf32_rna(a - __uint_as_float(big));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Store the tile's rows of z (staged in zs) with the out-shear folded in:
// out[r, w, n] = zs[f*V + (w - n) % V][n], times gate[(w - n) % V, n] for
// K5.  Each thread owns one kVec-column chunk and walks the rows.
template <typename T, bool kDx, int kBN, int kVec>
__device__ __forceinline__ void store_tile(const float* zs, T* out,
                                           const float* gate,
                                           int64_t row0, int rows, int v,
                                           int n0, int n) {
  constexpr int kLdz = kBN + 4;
  constexpr int kChunks = kBN / kVec;
  constexpr int kStep = kMmaThreads / kChunks;
  static_assert(kMmaThreads % kChunks == 0, "store walk");
  const int j = threadIdx.x % kChunks;
  const int col = n0 + j * kVec;
  if (col >= n) return;  // n % kVec == 0 on the vector path
  int nm[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) nm[e] = (col + e) % v;
  int m = threadIdx.x / kChunks;
  int f = m / v;
  int w = m - f * v;
  for (; m < rows; m += kStep) {
    float vals[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      int u = w - nm[e];
      u += u < 0 ? v : 0;
      float val = zs[(f * v + u) * kLdz + j * kVec + e];
      if (kDx) val *= __ldg(gate + u * n + col + e);
      vals[e] = val;
    }
    T* dst = out + (row0 + m) * n + col;
    if constexpr (kVec > 1) {
      store_vec(dst, vals);
    } else {
      store_f(dst, vals[0]);
    }
    w += kStep;
    while (w >= v) {
      w -= v;
      ++f;
    }
  }
}

// Persistent: block b takes tiles b, b + gridDim.x, ...; a tile is
// (frames whole frames, kBN output channels), the column tile the faster
// index.  kDx=false: K4, x (R, V, kdim) is the input, w (kdim, n)
// row-major, gate (V, kdim) on the input side, bias added.  kDx=true: K5,
// x is the cotangent (R, V, kdim) with kdim = D of the forward, w is the
// forward's (n, kdim) array read transposed, gate (V, n) multiplies the
// output at its source joint, no bias.  vec_x / vec_w / vec_g / vec_out:
// the 16-byte paths apply (row lengths and base pointers allow them).
template <typename T, bool kDx, int kBN>
__global__ void __launch_bounds__(kMmaThreads, kDx && kBN == 64 ? 2 : 1)
shift_gcn_mma_kernel(const T* __restrict__ x, const float* __restrict__ gate,
                     const float* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int r_total, int v, int kdim, int n, int frames,
                     int col_tiles, int tiles, bool vec_x, bool vec_w,
                     bool vec_g, bool vec_out) {
  using L = Layout<T, kDx, kBN>;
  constexpr int kNT = kBN / 32;
  constexpr int kLda = slab_ld<T>();
  constexpr int kVecX = vec_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* frag_ab = reinterpret_cast<uint4*>(smem);
  uint4* frag_as = frag_ab + L::kFragABytes / 16;
  uint4* frag_b = frag_as + L::kFragABytes / 16;
  float* zs = reinterpret_cast<float*>(frag_ab);  // aliases the fragments

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nk = (kdim + kK - 1) / kK;
  const int my_tiles = (tiles - static_cast<int>(blockIdx.x) +
                        static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  const int steps = my_tiles * nk;
  const int stage_bytes = L::stage_bytes(v);
  auto stage_base = [&](int p) {
    return smem + L::kRegionBytes + (p % kStages) * stage_bytes;
  };

  // copy stage p (tile p / nk, k-slice p % nk) into ring slot p % kStages
  auto issue = [&](int p) {
    const int tile = blockIdx.x + (p / nk) * gridDim.x;
    const int k0 = (p % nk) * kK;
    const int r0 = (tile / col_tiles) * frames;
    const int n0 = (tile % col_tiles) * kBN;
    const int rows = min(frames, r_total - r0) * v;
    const T* xb = x + static_cast<int64_t>(r0) * v * kdim;
    unsigned char* base = stage_base(p);
    T* xs = reinterpret_cast<T*>(base);
    float* ws = reinterpret_cast<float*>(base + L::kSlabBytes);
    if (vec_x) {
      constexpr int kChunks = kK / kVecX;
      for (int l = tid; l < rows * kChunks; l += kMmaThreads) {
        const int m = l / kChunks;
        const int j = l % kChunks;
        const int ch = k0 + j * kVecX;
        const bool in = ch < kdim;
        cp_async16(xs + m * kLda + j * kVecX,
                   in ? xb + static_cast<int64_t>(m) * kdim + ch : x, in);
      }
    } else {
      for (int l = tid; l < rows * kK; l += kMmaThreads) {
        const int m = l / kK;
        const int kk = l % kK;
        const int ch = k0 + kk;
        if constexpr (sizeof(T) == 4) {
          const bool in = ch < kdim;
          cp_async4(xs + m * kLda + kk,
                    in ? xb + static_cast<int64_t>(m) * kdim + ch : x, in);
        } else {
          xs[m * kLda + kk] = ch < kdim
                                  ? xb[static_cast<int64_t>(m) * kdim + ch]
                                  : zero_of<T>();
        }
      }
    }
    if (kDx) {
      // ws[c][kk] = W[n0 + c, k0 + kk]: W's rows, copied as they lie
      constexpr int kLdw = kK + 4;
      if (vec_w) {
        for (int l = tid; l < kBN * (kK / 4); l += kMmaThreads) {
          const int col = l / (kK / 4);
          const int j = l % (kK / 4);
          const int ch = k0 + 4 * j;
          const bool in = n0 + col < n && ch < kdim;
          cp_async16(ws + col * kLdw + 4 * j,
                     in ? w + static_cast<int64_t>(n0 + col) * kdim + ch : w,
                     in);
        }
      } else {
        for (int l = tid; l < kBN * kK; l += kMmaThreads) {
          const int col = l / kK;
          const int kk = l % kK;
          const bool in = n0 + col < n && k0 + kk < kdim;
          cp_async4(ws + col * kLdw + kk,
                    in ? w + static_cast<int64_t>(n0 + col) * kdim + k0 + kk
                       : w,
                    in);
        }
      }
    } else {
      // ws[kk][c] = W[k0 + kk, n0 + c]
      constexpr int kLdw = kBN + 8;
      if (vec_w) {
        for (int l = tid; l < kK * (kBN / 4); l += kMmaThreads) {
          const int kk = l / (kBN / 4);
          const int j = l % (kBN / 4);
          const int col = n0 + 4 * j;
          const bool in = k0 + kk < kdim && col < n;
          cp_async16(ws + kk * kLdw + 4 * j,
                     in ? w + static_cast<int64_t>(k0 + kk) * n + col : w,
                     in);
        }
      } else {
        for (int l = tid; l < kK * kBN; l += kMmaThreads) {
          const int kk = l / kBN;
          const int col = l % kBN;
          const bool in = k0 + kk < kdim && n0 + col < n;
          cp_async4(ws + kk * kLdw + col,
                    in ? w + static_cast<int64_t>(k0 + kk) * n + n0 + col : w,
                    in);
        }
      }
      // gs[u][kk] = gate[u, k0 + kk]
      float* gs = reinterpret_cast<float*>(base + L::kSlabBytes + L::kWBytes);
      if (vec_g) {
        for (int l = tid; l < v * (kK / 4); l += kMmaThreads) {
          const int u = l / (kK / 4);
          const int j = l % (kK / 4);
          const int ch = k0 + 4 * j;
          const bool in = ch < kdim;
          cp_async16(gs + u * kLdg + 4 * j, in ? gate + u * kdim + ch : gate,
                     in);
        }
      } else {
        for (int l = tid; l < v * kK; l += kMmaThreads) {
          const int u = l / kK;
          const int kk = l % kK;
          const bool in = k0 + kk < kdim;
          cp_async4(gs + u * kLdg + kk, in ? gate + u * kdim + k0 + kk : gate,
                    in);
        }
      }
    }
  };

  // The A pass: warp w builds the fragments of m16 tiles w/4 + 3*i at
  // k-step w%4 for every stage; its rows' frame offset and joint u are
  // fixed, so they are computed once here.
  const int a_k8 = warp % kK8;
  const int a_kk_lo = a_k8 * 8 + t;
  int a_fbase[kMT][2], a_u[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp / kK8 + 3 * i) * 16 + g + 8 * h;
      const int f = m < frames * v ? m / v : 0;
      a_fbase[i][h] = f * v * kLda;
      a_u[i][h] = m < frames * v ? m - f * v : 0;
    }
  }
  // The mma: warp (wm, wn) owns m16 tiles wm*kMT + i and n8 tiles wn*kNT + j
  const int wm = warp % kWarpsM;
  const int wn = warp / kWarpsM;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int p = 0; p < steps; ++p) {
    const int ks = p % nk;
    const int k0 = ks * kK;
    const int tile = blockIdx.x + (p / nk) * gridDim.x;
    const int r0 = (tile / col_tiles) * frames;
    const int n0 = (tile % col_tiles) * kBN;
    const int rows = min(frames, r_total - r0) * v;
    cp_async_wait<kStages - 2>();
    // stage p has landed; the last mma and the reads of ring slot
    // (p - 1) % kStages are done, so that slot takes stage p + kStages - 1
    __syncthreads();
    if (p + kStages - 1 < steps) issue(p + kStages - 1);
    cp_async_commit();

    // A pass: shear (and gate, K4), split into TF32 big / small
    {
      const unsigned char* base = stage_base(p);
      const float* gs =
          reinterpret_cast<const float*>(base + L::kSlabBytes + L::kWBytes);
      const T* xs = reinterpret_cast<const T*>(base);
      const int c_lo = k0 + a_kk_lo;
      const int cm_lo = c_lo % v;  // channel mod V, once per stage
      const int cm_hi = (c_lo + 4) % v;
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        float a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q & 1;  // a0, a2: row g; a1, a3: row g + 8
          const int hi = q >> 1;
          int s = a_u[i][h] + (hi ? cm_hi : cm_lo);
          s -= s >= v ? v : 0;
          float val =
              load_f(xs + a_fbase[i][h] + s * kLda + a_kk_lo + 4 * hi);
          if (!kDx) val *= gs[a_u[i][h] * kLdg + a_kk_lo + 4 * hi];
          a[q] = val;
        }
        uint4 big, small;
        split(a[0], big.x, small.x);
        split(a[1], big.y, small.y);
        split(a[2], big.z, small.z);
        split(a[3], big.w, small.w);
        const int slot = ((warp / kK8 + 3 * i) * kK8 + a_k8) * 32 + lane;
        frag_ab[slot] = big;
        frag_as[slot] = small;
      }
      // B pass: W (K4) or W^T (K5) fragments {big lo, big hi, small lo,
      // small hi}
      const float* ws = reinterpret_cast<const float*>(base + L::kSlabBytes);
      for (int l = tid; l < kBN / 8 * kK8 * 32; l += kMmaThreads) {
        const int nt = l >> 7;  // l / (kK8 * 32)
        const int k8 = (l >> 5) & (kK8 - 1);
        const int col = nt * 8 + ((l & 31) >> 2);
        const int klo = k8 * 8 + (l & 3);
        const float b_lo = kDx ? ws[col * (kK + 4) + klo]
                               : ws[klo * (kBN + 8) + col];
        const float b_hi = kDx ? ws[col * (kK + 4) + klo + 4]
                               : ws[(klo + 4) * (kBN + 8) + col];
        uint4 q;
        split(b_lo, q.x, q.z);
        split(b_hi, q.y, q.w);
        frag_b[l] = q;
      }
    }
    __syncthreads();  // the fragments are in place

    // 3xTF32 on the fragments: small*big + big*small, then big*big
    if (wn * kNT * 8 < n - n0) {
#pragma unroll
      for (int k8 = 0; k8 < kK8; ++k8) {
        if (k0 + k8 * 8 >= kdim) break;  // zero padding past the channels
        uint4 bq[kNT];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          bq[j] = frag_b[((wn * kNT + j) * kK8 + k8) * 32 + lane];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const int mt = wm * kMT + i;
          if (mt * 16 >= rows) break;  // tile past the frames
          const uint4 ab = frag_ab[(mt * kK8 + k8) * 32 + lane];
          const uint4 as = frag_as[(mt * kK8 + k8) * 32 + lane];
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            mma_tf32(acc[i][j], as.x, as.y, as.z, as.w, bq[j].x, bq[j].y);
            mma_tf32(acc[i][j], ab.x, ab.y, ab.z, ab.w, bq[j].z, bq[j].w);
            mma_tf32(acc[i][j], ab.x, ab.y, ab.z, ab.w, bq[j].x, bq[j].y);
          }
        }
      }
    }
    if (ks != nk - 1) continue;

    // epilogue: K4 adds the bias; z is staged over the fragments and
    // stored with the out-shear folded in, K5 multiplying by the gate of
    // the source joint there
    __syncthreads();
    constexpr int kLdz = kBN + 4;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = (wn * kNT + j) * 8 + 2 * t;
      const bool in0 = n0 + col < n, in1 = n0 + col + 1 < n;
      float b0 = 0.0f, b1 = 0.0f;
      if (!kDx) {
        b0 = in0 ? bias[n0 + col] : 0.0f;
        b1 = in1 ? bias[n0 + col + 1] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (wm * kMT + i) * 16 + g + 8 * h;
          *reinterpret_cast<float2*>(zs + m * kLdz + col) = make_float2(
              acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
      }
    }
    __syncthreads();
    const int64_t row0 = static_cast<int64_t>(r0) * v;
    if (vec_out) {
      store_tile<T, kDx, kBN, vec_elems<T>()>(zs, out, gate, row0, rows, v,
                                              n0, n);
    } else {
      store_tile<T, kDx, kBN, 1>(zs, out, gate, row0, rows, v, n0, n);
    }
  }
  cp_async_wait<0>();
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One launch of the template: r frames of v joints, kdim input channels,
// n output channels; as many persistent blocks as the SMs hold (at most
// one per tile).
template <typename T, bool kDx, int kBN>
int launch_tile(const void* x, const void* gate, const void* w,
                const void* bias, void* out, int r, int v, int kdim, int n,
                void* stream) {
  auto kernel = shift_gcn_mma_kernel<T, kDx, kBN>;
  const int smem = Layout<T, kDx, kBN>::bytes(v);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int frames = kRows / v;
  const int col_tiles = (n + kBN - 1) / kBN;
  const int64_t tiles =
      static_cast<int64_t>((r + frames - 1) / frames) * col_tiles;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kMmaThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(tiles < slots ? tiles : slots);
  constexpr int kVec = vec_elems<T>();
  const bool vec_x = kdim % kVec == 0 && aligned16(x);
  const bool vec_w = (kDx ? kdim : n) % 4 == 0 && aligned16(w);
  const bool vec_g = kdim % 4 == 0 && aligned16(gate);
  const bool vec_out = n % kVec == 0 && aligned16(out);
  kernel<<<blocks, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(gate),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), r, v, kdim, n, frames, col_tiles,
      static_cast<int>(tiles), vec_x, vec_w, vec_g, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDx>
int launch(const void* x, const void* gate, const void* w, const void* bias,
           void* out, int r, int v, int kdim, int n, void* stream) {
  if (v < 1 || v > kRows) return static_cast<int>(cudaErrorInvalidValue);
  if (r == 0 || kdim == 0 || n == 0) return 0;
  return n > 64 ? launch_tile<T, kDx, 128>(x, gate, w, bias, out, r, v, kdim,
                                           n, stream)
                : launch_tile<T, kDx, 64>(x, gate, w, bias, out, r, v, kdim, n,
                                          stream);
}

}  // namespace

// K4: out (r, v, d) from x (r, v, c), gate (v, c), W (c, d), bias (d).
extern "C" int shift_gcn_forward(const void* x, const void* gate,
                                 const void* w, const void* bias, void* out,
                                 int r, int v, int c, int d, int is_bf16,
                                 void* stream) {
  return is_bf16 ? launch<__nv_bfloat16, false>(x, gate, w, bias, out, r, v,
                                                c, d, stream)
                 : launch<float, false>(x, gate, w, bias, out, r, v, c, d,
                                        stream);
}

// K5: dx (r, v, c) from the cotangent g (r, v, d), the forward's gate
// (v, c) and W (c, d).
extern "C" int shift_gcn_dx(const void* g, const void* gate, const void* w,
                            void* dx, int r, int v, int c, int d,
                            int is_bf16, void* stream) {
  return is_bf16 ? launch<__nv_bfloat16, true>(g, gate, w, nullptr, dx, r, v,
                                               d, c, stream)
                 : launch<float, true>(g, gate, w, nullptr, dx, r, v, d, c,
                                       stream);
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
