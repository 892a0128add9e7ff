// Fractional temporal shift: forward (K1) and its constraint backward
// (K2 grad_input and K3 position grad, fused into one pass).
//
// Replaces the Pallas TPU kernel of the reference package,
// ops/pallas/temporal_shift_kernel.py::_tshift_kernel, in its three uses:
// hat mode through temporal_shift_pallas / _fwd (K1), hat mode on the
// zero-dilated cotangent with negated positions from _bwd :192-193 (K2),
// and diff mode plus the fp32 reduction from _bwd :195-197 (K3).  Per
// channel c:
//
//   y      = ypos[c] + (stride != 1 ? 0.5 : 0)
//   lo     = floor(y),  f = y - lo
//   out[n, t, v, c] = (1 - f) * x[n, t*stride + lo, v, c]
//                   +      f  * x[n, t*stride + lo + 1, v, c]
//
// with reads outside [0, T_in) taken as zero.
//
// Both kernels are bound by memory on the H100: a few flops per element
// against one read of each input and one write of each output, so the
// floor is the bytes over 3.35 TB/s.  Both are one tile design, built for
// that bound (the per-row kernels it replaced ran slower in bf16 than in
// fp32, bound by instructions and scattered 2-byte accesses):
// - Template on the dtype, the stride (1, 2; "* s", "% s" and "/ s"
//   compile to shifts and masks) and, in the backward, on which outputs
//   are wanted (dx, gy_raw or both), so the dx-only and gy-only launchers
//   run the same code.
// - A block owns a tile: clip n, a slab of channels that is one 128-byte
//   row (32 fp32 or 64 bf16: no lane idles at C = 64, 128, 256), all V
//   joints, and a run of frames (16 input frames in fp32, 8 in bf16).
//   Its 384 lanes are (vector of channels, frame, joint group): a lane
//   computes its channels' taps once, from lo and f staged per channel in
//   shared memory, and walks its joints (11 at V=33) with plain
//   increments (4 in flight in the backward, 2 in the forward); its own
//   operands and results move as
//   16-byte (fp32) or 8-byte (bf16) vectors.  No floating-point atomics.
// - A vector's channels take their taps from different frames, so the
//   tapped tensor cannot be gathered as vectors: the frames the tile reads
//   are staged into shared memory as they lie with cp.async, with a zero
//   frame after them, and each lane reads its channels' taps from there
//   without a branch.  A lane with a tap outside the staged window takes a
//   second copy of the walk that reads such taps from device memory:
//   correct at any ypos, only slower.  Where V is so large that the window
//   does not fit in a block's shared memory (by the current device's
//   limits), fewer frames are staged and more taps take that walk.
// - C not a multiple of the vector, or unaligned tensors: the same
//   template with 1-element lanes and 8-channel slabs.
//
// K1 (tshift_forward_kernel).  A tile is kRun / s output frames (16 / s
// in fp32, 8 / s in bf16), so the input frames it reads, not its outputs,
// are fixed across strides; its lanes are (vector, output frame, joint
// group of 3s).  Output frame t of channel c reads input frames t*s + lo
// and t*s + lo + 1, so the tile stages the frames [t0*s + lo_min,
// (t0 + R - 1)*s + lo_max + 1] of its slab, clamped to [0, T_in): the
// (R - 1)*s + 2 frames of its run and the spread of lo across the slab.
// The zero frame stands for taps outside [0, T_in); each output vector is
// one streaming store.  The Pallas version zero-padded T and summed
// 2*max_shift+2 taps; here each output reads its two source frames.
// What was timed and kept (root PERF.md, PR 6):
// - The kernel's 80 registers allow two blocks an SM, so the window is
//   as many frames as fit while two blocks share one (25 at V=33: a
//   spread of lo up to 8 frames in fp32, 16 in bf16, at stride 1) and
//   costs no occupancy; a window of the run plus 6 frames was as fast at
//   the model's init shifts and read far more taps from device memory
//   at spread-out ones.
// - fp32 rows are staged rotated (rotated_word, by 4-byte copies), which
//   takes the lanes' scalar tap reads from a 4-way bank conflict to none:
//   -5%.  bf16 rows lie as they are (a 2-way conflict): rotating them
//   costs more in 4-byte copies than it saves.
// - bf16 rows are copied 16 bytes at a time (cp.async.cg, which bypasses
//   L1) where C and x allow: 8-byte copies go through L1 and hold its
//   lines in flight, which a large window leaves too few of.
// - Two joints in flight a lane: four spilled the device-memory walk.
//   8-element bf16 lanes, 3 or 4 blocks an SM in bf16 (fewer registers,
//   which spill that walk) and staging in two halves did not pay.
// Backward (tshift_backward_kernel).  Input frame k of channel c gathers
// two cotangent taps, a = g[(k - lo) / s] and b = g[(k - lo - 1) / s],
// each zero unless its offset is a non-negative multiple of s below
// T_out * s (the stride-2 evenness rule):
//   K2  dx[k] = (1 - f) a + f b, the exact transpose of K1.  The Pallas
//       version built the zero-dilated cotangent in memory and ran the
//       forward with -y; nothing is dilated here.
//   K3  gy_raw[c] = (1/N) sum_{n,t,v} (x[t*s+lo+1] - x[t*s+lo]) g[t]
//                 = (1/N) sum_{n,k,v} x[k] (b - a),
//       the same sum re-indexed over input frames: an x frame outside
//       [0, T_in) is zero in the first form and never a k in the second,
//       a tap outside [0, T_out) is zero in both.  So one lane that holds
//       x[k], a and b produces both outputs, and x and g are read once.
//       The input-frame order is used because it is the order in which
//       the lane already holds its operands.
// The sum is fp32 in a fixed order, with no floating-point atomics: the
// sign of gy_raw at a tie sits at roundoff scale, so a run-to-run order
// would make training nondeterministic.  Each block sums its tile's
// (frames x V) terms per channel (each lane over its joints in order,
// then the lanes in order) into one row of a scratch matrix; a final pass
// sums the rows in block order and divides by N.  A tile is (4-channel
// vector, input frame, joint group of 3); it stages the cotangent frames
// its taps read (the run plus a halo, at most run/s + 8), with the zero
// frame for taps outside [0, T_out) or of the wrong parity.  Shared
// memory at V=33: 106 KB (fp32, stride 1; two blocks an SM), 72 KB (bf16,
// stride 1; three).  Its choices were timed against 8-element bf16 lanes,
// other unroll depths, a 4-frame halo and prefetching the next joint's x
// (root PERF.md).  On an H100 SXM at 700 W the pass runs at 70% of its
// bytes bound in fp32 and 61% in bf16 at the training shapes
// (chip_smoke.py phase 10).
//
// Math is fp32, I/O fp32 or bf16.  In K1 and dx the products and the sum
// are rounded separately (__fmul_rn/__fadd_rn) so the result equals the
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

// ---------------------------------------------------------------------------
// The tile both kernels use, and its vector lanes
// ---------------------------------------------------------------------------

constexpr int kGroups = 3;      // joint groups (11 joints a lane at V=33)
constexpr int kTileThreads = 384;
constexpr int kVec = 4;         // elements a lane moves: 16 B fp32, 8 B bf16
constexpr int kHalo = 8;        // backward: staged frames beyond kRun / S
constexpr int kFwdBlocks = 2;   // forward: blocks an SM (its registers)
constexpr int kPadBytes = 32;   // after each staged frame; keeps rows aligned
constexpr int kMinRun = 8;      // the shortest run of any tile shape
constexpr int kUnroll = 4;      // backward: joints a lane has in flight
constexpr int kFwdUnroll = 2;   // forward: the same (deeper spills)
constexpr int kFinalRows = 32;  // final pass: row lanes per channel
constexpr int kLaneCh = 32;     // final pass: channels per block
constexpr int kStaticBytes = 1024;  // the tile kernel's static shared memory

// A tile's shape for I/O type T and VEC elements a lane: kCv lanes across a
// slab of CS channels, kRun input frames, kGroups joint groups; 384 lanes.
// At VEC = 4 a slab row is 128 bytes: fp32 8 lanes x 16 frames, bf16 16
// lanes x 8 frames.  At VEC = 1 (C not a multiple of 4, or unaligned
// tensors): 8 lanes x 16 frames.
// The forward's run is kRun / S output frames (the same input frames) in
// kGroups * S joint groups.
template <typename T, int VEC>
struct Tile {
  static constexpr int kCv =
      VEC == 1 ? 8 : 128 / (VEC * static_cast<int>(sizeof(T)));
  static constexpr int kRun = kTileThreads / (kCv * kGroups);
  static constexpr int CS = kCv * VEC;
};
// temporal_shift_backward_rows sizes the scratch by the shortest run
static_assert(Tile<__nv_bfloat16, kVec>::kRun == kMinRun &&
                  Tile<float, kVec>::kRun >= kMinRun &&
                  Tile<float, 1>::kRun >= kMinRun &&
                  Tile<__nv_bfloat16, 1>::kRun >= kMinRun,
              "kMinRun is the shortest run of any tile shape");

__device__ __forceinline__ void load_vec(const float* p, float (&o)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}
// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 bits
__device__ __forceinline__ void unpack_bf16(uint32_t w, float& lo,
                                            float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&o)[4]) {
  const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
  unpack_bf16(t.x, o[0], o[1]);
  unpack_bf16(t.y, o[2], o[3]);
}
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[1]) {
  o[0] = load_f(p);
}
__device__ __forceinline__ void store_vec(float* p, const float (&o)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&o)[4]) {
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3])));
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&o)[1]) {
  store_f(p, o[0]);
}

// one vector of VEC elements from device memory into shared memory:
// cp.async of 16 or 8 bytes, or a plain copy of one element
template <int VEC, typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (VEC * sizeof(T) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else if constexpr (VEC * sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  } else {
    *dst = *src;
  }
}

// Step 1 of both kernels: lo and frac of the slab's CS channels into
// shared memory, lo clamped where every tap of the channel is out of range
// whatever its value, then the slab's range of lo into range_s.
template <int CS, int S>
__device__ __forceinline__ void slab_positions(
    const float* __restrict__ ypos, int c0, int c, int t_in, int t_out,
    float offset, int* lo_s, float* frac_s, int* range_s) {
  const int tid = threadIdx.x;
  if (tid < CS) {
    int lo = 0;
    float fr = 0.0f;
    if (c0 + tid < c) {
      const float y = ypos[c0 + tid] + offset;
      const float lo_f = floorf(y);
      fr = y - lo_f;
      lo = min(max(static_cast<int>(lo_f), -(t_out * S + 1)), t_in + 1);
    }
    lo_s[tid] = lo;
    frac_s[tid] = fr;
  }
  __syncthreads();
  if (tid < 32) {
    int lo_min = 0x7fffffff, lo_max = -0x7fffffff - 1;
    for (int i = tid; i < CS && c0 + i < c; i += 32) {
      lo_min = min(lo_min, lo_s[i]);
      lo_max = max(lo_max, lo_s[i]);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      lo_min = min(lo_min, __shfl_xor_sync(0xffffffffu, lo_min, m));
      lo_max = max(lo_max, __shfl_xor_sync(0xffffffffu, lo_max, m));
    }
    if (tid == 0) {
      range_s[0] = lo_min;
      range_s[1] = lo_max;
    }
  }
  __syncthreads();
}

// Stages frames [w0, w0 + nq) of one slab (V rows of CS channels a frame,
// from src = frame w0, joint 0, the lane's channel) into win as they lie,
// frame stride fs, and zeroes the frame at `zero`; cp.async, not waited for.
template <typename T, int VEC, int kCv, int CS, int kThreads>
__device__ __forceinline__ void stage_window(T* win, const T* src, bool lane,
                                             int nq, int v, int c, int fs,
                                             int zero) {
  const int tid = threadIdx.x;
  for (int r = tid; r < v * CS; r += kThreads) win[zero + r] = T(0.0f);
  if (lane) {
    const int pad = fs - v * CS;
    for (int r = tid / kCv; r < nq * v; r += kThreads / kCv) {
      stage_vec<VEC>(win + r * CS + (r / v) * pad + (tid % kCv) * VEC,
                     src + static_cast<int64_t>(r) * c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// ---------------------------------------------------------------------------
// Forward: K1
// ---------------------------------------------------------------------------

// fp32 vector lanes read a window whose rows are rotated: a lane reads its
// VEC channels one at a time, and in a row staged as it lies channel i of
// every lane sits in the 8 banks = i mod 4, a 4-way conflict across the
// warp's 4 frames.  So each row's words are rotated within groups of 4 by
// the frame (q / S), which spreads the frames over all 32 banks.  A bf16
// row would need 4-byte copies to rotate its words, which cost more than
// its 2-way conflict (root PERF.md), so bf16 rows lie as they are.
template <typename T, int VEC>
constexpr bool kRotated = VEC > 1 && sizeof(T) == 4;

template <int S>
__device__ __forceinline__ int rotated_word(int word, int q) {
  return (word & ~3) | ((word + (q >> (S - 1))) & 3);
}

// Stages fp32 frames [w0, w0 + nq) of one slab (src: frame w0, joint 0,
// channel c0) with rotated rows: a warp copies a whole 128-byte row, one
// 4-byte cp.async a lane, lane l's word to rotated_word(l, q).
template <int S, int CS, int kThreads>
__device__ __forceinline__ void stage_rows_rotated(float* win,
                                                   const float* src, bool ok,
                                                   int nq, int v, int c,
                                                   int fs, int zero) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  for (int r = tid; r < v * CS; r += kThreads) win[zero + r] = 0.0f;
  if (ok) {
    const int pad = fs - v * CS;
    for (int r = tid / 32; r < nq * v; r += kThreads / 32) {
      const int q = r / v;
      const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(
          win + r * CS + q * pad + rotated_word<S>(lane, q)));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src + static_cast<int64_t>(r) * c + lane));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Where a lane reads input frame k for its channel `slot` of the slab: a
// staged element at joint 0, or the zero frame for k outside [0, T_in),
// both >= 0; or, for a frame outside the staged window, -1 - k (read from
// device memory).
template <typename T, int S, int VEC>
__device__ __forceinline__ int forward_tap(int k, int t_in, int w0, int nq,
                                           int zero, int fs, int slot) {
  if (k < 0 || k >= t_in) return zero + slot;
  const int q = k - w0;
  if (static_cast<unsigned>(q) >= static_cast<unsigned>(nq)) return -1 - k;
  return q * fs + (kRotated<T, VEC> ? rotated_word<S>(slot, q) : slot);
}

// The lane's joint walk: out = (1 - f) a + f b, products and sum rounded
// separately.  kSpill: some tap lies outside the staged window and is read
// from device memory (xn: clip n, frame 0, joint 0, the lane's channel).
template <typename T, int VEC, bool kSpill>
__device__ __forceinline__ void forward_walk(
    const T* __restrict__ win, const T* __restrict__ xn, T* __restrict__ orow,
    const int (&oa)[VEC], const int (&ob)[VEC], const float (&frac)[VEC],
    int j_begin, int j_end, int cs, int v, int c) {
  auto tap = [&](int o, int j, int i) -> float {
    if (!kSpill || o >= 0) return load_f(win + o + j * cs);
    return load_f(xn + i + (static_cast<int64_t>(-1 - o) * v + j) * c);
  };
  float keep[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) keep[i] = 1.0f - frac[i];
#pragma unroll kFwdUnroll
  for (int j = j_begin; j < j_end; ++j) {
    float o[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      o[i] = __fadd_rn(__fmul_rn(keep[i], tap(oa[i], j, i)),
                       __fmul_rn(frac[i], tap(ob[i], j, i)));
    }
    store_vec(orow + static_cast<int64_t>(j) * c, o);
  }
}

// The forward's tile: kRun output frames (the input frames of Tile's run),
// kJg joint groups, kThreads lanes.
template <typename T, int S, int VEC>
struct ForwardTile {
  static constexpr int kRun = Tile<T, VEC>::kRun / S;
  static constexpr int kJg = kGroups * S;
  static constexpr int kThreads = Tile<T, VEC>::kCv * kRun * kJg;
};

// Block: clip n, output frames [t0, t0 + kRun), channels [c0, c0 + CS),
// all V joints.  Lane (cv, f, jg) owns the VEC channels c0 + cv*VEC.., the
// output frame t0 + f and the joints of group jg.
template <typename T, int S, int VEC>
__global__ void __launch_bounds__(ForwardTile<T, S, VEC>::kThreads,
                                  kFwdBlocks)
tshift_forward_kernel(const T* __restrict__ x, const float* __restrict__ ypos,
                      T* __restrict__ out, int t_in, int t_out, int v, int c,
                      int runs, int w, float offset) {
  using Shape = Tile<T, VEC>;
  using Fwd = ForwardTile<T, S, VEC>;
  constexpr int kCv = Shape::kCv;
  constexpr int kRun = Fwd::kRun;
  constexpr int kJg = Fwd::kJg;
  constexpr int CS = Shape::CS;
  constexpr int PAD = kPadBytes / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);  // [w + 1][V * CS + PAD], frame w 0
  __shared__ int lo_s[CS];
  __shared__ float frac_s[CS];
  __shared__ int range_s[2];

  const int tid = threadIdx.x;
  const int cv = tid % kCv;
  const int f = (tid / kCv) % kRun;
  const int jg = tid / (kCv * kRun);
  const int tile = blockIdx.x;  // n * runs + run
  const int n = tile / runs;
  const int t0 = (tile - n * runs) * kRun;
  const int c0 = blockIdx.y * CS;
  const int ch = c0 + cv * VEC;  // the lane's first channel
  const int t = t0 + f;          // the lane's output frame
  const int fs = v * CS + PAD;   // staged frame stride

  // 1. lo and frac per channel, the slab's range of lo
  slab_positions<CS, S>(ypos, c0, c, t_in, t_out, offset, lo_s, frac_s,
                        range_s);

  // 2. stage the input frames [w0, w0 + nq) that the tile's taps read, at
  //    most w of them, and a zero frame after them: fp32 rows rotated,
  //    bf16 rows by 16-byte copies where C and x allow (they bypass L1),
  //    else by the lanes' own vectors
  const int t_last = min(t0 + kRun, t_out) - 1;
  const int w0 = max(t0 * S + range_s[0], 0);
  const int nq =
      max(0, min(min(t_last * S + range_s[1] + 1, t_in - 1) - w0 + 1, w));
  const int zero = w * fs;
  const T* xn = x + static_cast<int64_t>(n) * t_in * v * c + ch;
  const T* xw = x + (static_cast<int64_t>(n) * t_in + w0) * v * c;
  if constexpr (kRotated<T, VEC>) {
    stage_rows_rotated<S, CS, Fwd::kThreads>(win, xw + c0, c0 + tid % 32 < c,
                                             nq, v, c, fs, zero);
  } else if (sizeof(T) == 2 && VEC > 1 && c % 8 == 0 &&
             reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int sc = c0 + (tid % 8) * 8;
    stage_window<T, 8, 8, CS, Fwd::kThreads>(win, xw + sc, sc < c, nq, v, c,
                                             fs, zero);
  } else {
    stage_window<T, VEC, kCv, CS, Fwd::kThreads>(win, xw + ch, ch < c, nq, v,
                                                 c, fs, zero);
  }

  // 3. meanwhile, each channel's two taps (a at t*S + lo, b one frame on)
  float frac[VEC];
  int oa[VEC], ob[VEC];
  bool spill = false;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int slot = cv * VEC + i;
    const int k = t * S + lo_s[slot];
    frac[i] = frac_s[slot];
    oa[i] = forward_tap<T, S, VEC>(k, t_in, w0, nq, zero, fs, slot);
    ob[i] = forward_tap<T, S, VEC>(k + 1, t_in, w0, nq, zero, fs, slot);
    spill |= oa[i] < 0 || ob[i] < 0;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // 4. walk the lane's joints
  if (ch < c && t < t_out) {
    const int per_group = (v + kJg - 1) / kJg;
    const int j_begin = jg * per_group;
    const int j_end = min(v, j_begin + per_group);
    T* orow = out + (static_cast<int64_t>(n) * t_out + t) * v * c + ch;
    if (spill) {
      forward_walk<T, VEC, true>(win, xn, orow, oa, ob, frac, j_begin, j_end,
                                 CS, v, c);
    } else {
      forward_walk<T, VEC, false>(win, xn, orow, oa, ob, frac, j_begin,
                                  j_end, CS, v, c);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: K2 (grad_input) and K3's partial sums in one pass
// ---------------------------------------------------------------------------

template <int S>
__device__ __forceinline__ int floor_div(int a) {
  return S == 1 ? a : (a >> 1);  // arithmetic shift: floor for a < 0 too
}

// Where a lane reads the tap of cotangent offset kk (= output frame kk / S
// where that is whole): a staged element at joint 0, or the zero frame
// staged after the window (zero outside [0, T_out * S) and, at stride 2,
// at odd kk), both >= 0; or, for a frame outside the staged window,
// -1 - frame (read from device memory).
template <int S>
__device__ __forceinline__ int tap_offset(int kk, int t_out, int w0, int nq,
                                          int zero, int fs, int slot) {
  if (kk < 0 || kk >= t_out * S || kk % S != 0) return zero + slot;
  const int q = kk / S;
  return (q >= w0 && q - w0 < nq) ? (q - w0) * fs + slot : -1 - q;
}

// The lane's joint walk: dx[k] = (1 - f) a + f b, and the gy_raw terms
// x[k] * (b - a) summed per channel in joint order.  kSpill: some tap lies
// outside the staged window and is read from device memory.
template <typename T, int VEC, bool DX, bool GY, bool kSpill>
__device__ __forceinline__ void walk_joints(
    const T* __restrict__ x, const T* __restrict__ win,
    const T* __restrict__ gn, T* __restrict__ dx, const int (&oa)[VEC],
    const int (&ob)[VEC], const float (&frac)[VEC], float (&acc)[VEC],
    int64_t row, int ch, int j_begin, int j_end, int cs, int v, int c) {
  auto tap = [&](int o, int j, int i) -> float {
    if (!kSpill || o >= 0) return load_f(win + o + j * cs);
    return load_f(gn + i + (static_cast<int64_t>(-1 - o) * v + j) * c);
  };
#pragma unroll kUnroll
  for (int j = j_begin; j < j_end; ++j) {
    const int64_t e = (row + j) * c + ch;
    float xv[VEC];
    if constexpr (GY) load_vec(x + e, xv);
    float a[VEC], b[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      a[i] = tap(oa[i], j, i);
      b[i] = tap(ob[i], j, i);
    }
    if constexpr (DX) {
      float d[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        d[i] = __fadd_rn(__fmul_rn(1.0f - frac[i], a[i]),
                         __fmul_rn(frac[i], b[i]));
      }
      store_vec(dx + e, d);
    }
    if constexpr (GY) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(xv[i], b[i] - a[i], acc[i]);
    }
  }
}

// Block: clip n, input frames [k0, k0 + kRun), channels [c0, c0 + CS),
// all V joints.  Lane (cv, f, jg) owns the VEC channels c0 + cv*VEC.., the
// input frame k0 + f and the joints of group jg: its taps' frames are fixed
// per channel, so the index math is done once and the joint walk is plain
// increments.
template <typename T, int S, int VEC, bool DX, bool GY>
__global__ void __launch_bounds__(kTileThreads, 2)
tshift_backward_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ ypos, T* __restrict__ dx,
                       float* __restrict__ partial, int t_in, int t_out,
                       int v, int c, int runs, int w, float offset) {
  using Shape = Tile<T, VEC>;
  constexpr int kCv = Shape::kCv;
  constexpr int kRun = Shape::kRun;
  constexpr int CS = Shape::CS;
  constexpr int PAD = kPadBytes / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);  // [w + 1][V * CS + PAD], frame w 0
  __shared__ int lo_s[CS];
  __shared__ float frac_s[CS];
  __shared__ int range_s[2];

  const int tid = threadIdx.x;
  const int cv = tid % kCv;
  const int f = (tid / kCv) % kRun;
  const int jg = tid / (kCv * kRun);
  const int tile = blockIdx.x;  // n * runs + run
  const int n = tile / runs;
  const int k0 = (tile - n * runs) * kRun;
  const int c0 = blockIdx.y * CS;
  const int ch = c0 + cv * VEC;  // the lane's first channel
  const int k = k0 + f;          // the lane's input frame
  const int fs = v * CS + PAD;   // staged frame stride

  // 1. lo and frac per channel, the slab's range of lo
  slab_positions<CS, S>(ypos, c0, c, t_in, t_out, offset, lo_s, frac_s,
                        range_s);

  // 2. stage the cotangent frames [w0, w0 + nq) that the tile's taps read,
  //    at most w of them, as they lie (V rows of CS channels a frame), and
  //    a zero frame after them
  const int k_last = min(k0 + kRun, t_in) - 1;
  const int w0 = max(floor_div<S>(k0 - range_s[1] - 1), 0);
  const int nq = max(
      0, min(min(floor_div<S>(k_last - range_s[0]), t_out - 1) - w0 + 1, w));
  const int zero = w * fs;
  stage_window<T, VEC, kCv, CS, kTileThreads>(
      win, g + (static_cast<int64_t>(n) * t_out + w0) * v * c + ch, ch < c,
      nq, v, c, fs, zero);

  // 3. meanwhile, each channel's two taps (a at k - lo, b at k - lo - 1)
  float frac[VEC];
  int oa[VEC], ob[VEC];
  bool spill = false;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int slot = cv * VEC + i;
    const int ka = k - lo_s[slot];
    frac[i] = frac_s[slot];
    oa[i] = tap_offset<S>(ka, t_out, w0, nq, zero, fs, slot);
    ob[i] = tap_offset<S>(ka - 1, t_out, w0, nq, zero, fs, slot);
    spill |= oa[i] < 0 || ob[i] < 0;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // 4. walk the lane's joints
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  if (ch < c && k < t_in) {
    const int per_group = (v + kGroups - 1) / kGroups;
    const int j_begin = jg * per_group;
    const int j_end = min(v, j_begin + per_group);
    const int64_t row = (static_cast<int64_t>(n) * t_in + k) * v;
    const T* gn = g + static_cast<int64_t>(n) * t_out * v * c + ch;
    if (spill) {
      walk_joints<T, VEC, DX, GY, true>(x, win, gn, dx, oa, ob, frac, acc,
                                        row, ch, j_begin, j_end, CS, v, c);
    } else {
      walk_joints<T, VEC, DX, GY, false>(x, win, gn, dx, oa, ob, frac, acc,
                                         row, ch, j_begin, j_end, CS, v, c);
    }
  }

  // 5. the tile's partial row: lanes summed per channel in lane order
  if constexpr (GY) {
    __syncthreads();  // every lane is done with the window
    float* red = reinterpret_cast<float*>(smem);  // [kRun * kGroups][CS]
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[(tid / kCv) * CS + cv * VEC + i] = acc[i];
    __syncthreads();
    if (tid < CS && c0 + tid < c) {
      float s = 0.0f;
      for (int r = 0; r < kRun * kGroups; ++r) s += red[r * CS + tid];
      partial[static_cast<int64_t>(tile) * c + c0 + tid] = s;
    }
  }
}

// pass 2: gy_raw[c] = (sum of the tiles' partial rows, in order) / N; row
// lane l sums rows l, l + kFinalRows, ..., then the lanes are summed in order
__global__ void __launch_bounds__(kLaneCh * kFinalRows)
tshift_position_final_kernel(const float* __restrict__ partial,
                             float* __restrict__ out, int rows, int c,
                             float n) {
  __shared__ float lanes[kFinalRows][kLaneCh + 1];
  const int ch = blockIdx.x * kLaneCh + threadIdx.x;
  float acc = 0.0f;
  if (ch < c) {
    for (int k = threadIdx.y; k < rows; k += kFinalRows) {
      acc += partial[static_cast<int64_t>(k) * c + ch];
    }
  }
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kFinalRows; ++k) s += lanes[k][threadIdx.x];
    out[ch] = s / n;
  }
}

// The frames a tile stages: `want`, or fewer where they do not fit beside
// the zero frame in a block's shared memory while `blocks` blocks share an
// SM (the current device's limits); taps outside the window are read from
// device memory.  Where V is so large that not one frame fits beside the
// zero frame, the tile stages none (every tap in range from device
// memory), and where the zero frame alone does not fit while `blocks`
// share an SM, fewer share it; with one block a frame of V * CS elements
// must fit (V <= 1807 at a 128-byte slab row on an H100).  Sets *w and
// the window's bytes, zero frame included.
template <typename T, int VEC>
cudaError_t window_frames(int v, int want, int blocks, int* w,
                          size_t* bytes) {
  int device = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  }
  if (err != cudaSuccess) return err;
  const int64_t frame =
      static_cast<int64_t>(v) * Tile<T, VEC>::CS * sizeof(T) + kPadBytes;
  int64_t fit = -1;
  for (; blocks >= 1 && fit < 0; --blocks) {
    const int64_t room = per_sm / blocks - reserved;
    fit = ((room < optin ? room : optin) - kStaticBytes) / frame - 1;
  }
  if (fit < 0) return cudaErrorInvalidValue;
  *w = static_cast<int>(fit < want ? fit : want);
  *bytes = static_cast<size_t>((*w + 1) * frame);
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int S, int VEC>
cudaError_t launch_forward(const void* x, const void* ypos, void* out, int n,
                           int t_in, int t_out, int v, int c,
                           cudaStream_t s) {
  using Shape = Tile<T, VEC>;
  using Fwd = ForwardTile<T, S, VEC>;
  constexpr int kRun = Fwd::kRun;
  const int runs = (t_out + kRun - 1) / kRun;
  // as many frames as fit while kFwdBlocks blocks share an SM
  int w = 0;
  size_t bytes = 0;
  cudaError_t err =
      window_frames<T, VEC>(v, 1 << 20, kFwdBlocks, &w, &bytes);
  auto kernel = tshift_forward_kernel<T, S, VEC>;
  if (err == cudaSuccess) err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n * runs, (c + Shape::CS - 1) / Shape::CS);
  kernel<<<grid, Fwd::kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(ypos),
      static_cast<T*>(out), t_in, t_out, v, c, runs, w,
      S != 1 ? 0.5f : 0.0f);
  return cudaGetLastError();
}

// the vector path where C and both pointers allow it, else 1-element lanes
template <typename T>
cudaError_t forward_dispatch(const void* x, const void* ypos, void* out,
                             int n, int t_in, int t_out, int v, int c,
                             int stride, cudaStream_t s) {
  constexpr int kV = kVec;
  constexpr int kBytes = kV * static_cast<int>(sizeof(T));
  const bool vec = c % kV == 0 && aligned(x, kBytes) && aligned(out, kBytes);
  if (stride == 1) {
    return vec ? launch_forward<T, 1, kV>(x, ypos, out, n, t_in, t_out, v, c,
                                          s)
               : launch_forward<T, 1, 1>(x, ypos, out, n, t_in, t_out, v, c,
                                         s);
  }
  return vec ? launch_forward<T, 2, kV>(x, ypos, out, n, t_in, t_out, v, c, s)
             : launch_forward<T, 2, 1>(x, ypos, out, n, t_in, t_out, v, c, s);
}

// Launches the backward tile kernel; returns its error and sets *rows to
// the number of partial rows it writes (one per tile).
template <typename T, int S, int VEC, bool DX, bool GY>
cudaError_t launch_backward(const void* x, const void* g, const void* ypos,
                            void* dx, void* partial, int n, int t_in,
                            int t_out, int v, int c, int* rows,
                            cudaStream_t s) {
  using Shape = Tile<T, VEC>;
  const int runs = (t_in + Shape::kRun - 1) / Shape::kRun;
  // staged frames: the run plus the halo
  int w = 0;
  size_t window = 0;
  cudaError_t err =
      window_frames<T, VEC>(v, Shape::kRun / S + kHalo, 1, &w, &window);
  const size_t reduce = GY ? sizeof(float) * kTileThreads * VEC : 0;
  const size_t bytes = window > reduce ? window : reduce;
  auto kernel = tshift_backward_kernel<T, S, VEC, DX, GY>;
  if (err == cudaSuccess) err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  *rows = n * runs;
  const dim3 grid(n * runs, (c + Shape::CS - 1) / Shape::CS);
  kernel<<<grid, kTileThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(ypos), static_cast<T*>(dx),
      static_cast<float*>(partial), t_in, t_out, v, c, runs, w,
      S != 1 ? 0.5f : 0.0f);
  return cudaGetLastError();
}

template <typename T, int S, int VEC>
cudaError_t backward_outputs(const void* x, const void* g, const void* ypos,
                             void* dx, void* partial, bool gy, int n,
                             int t_in, int t_out, int v, int c, int* rows,
                             cudaStream_t s) {
  if (dx != nullptr && gy) {
    return launch_backward<T, S, VEC, true, true>(x, g, ypos, dx, partial, n,
                                                  t_in, t_out, v, c, rows, s);
  }
  if (dx != nullptr) {
    return launch_backward<T, S, VEC, true, false>(
        x, g, ypos, dx, partial, n, t_in, t_out, v, c, rows, s);
  }
  return launch_backward<T, S, VEC, false, true>(x, g, ypos, dx, partial, n,
                                                 t_in, t_out, v, c, rows, s);
}

// the vector path where C and every pointer allow it, else 1-element lanes
template <typename T>
cudaError_t backward_dispatch(const void* x, const void* g, const void* ypos,
                              void* dx, void* partial, bool gy, int n,
                              int t_in, int t_out, int v, int c, int stride,
                              int* rows, cudaStream_t s) {
  constexpr int kBytes = kVec * static_cast<int>(sizeof(T));
  const bool vec = c % kVec == 0 && aligned(x, kBytes) &&
                   aligned(g, kBytes) && aligned(dx, kBytes);
  if (stride == 1) {
    return vec ? backward_outputs<T, 1, kVec>(x, g, ypos, dx, partial, gy, n,
                                              t_in, t_out, v, c, rows, s)
               : backward_outputs<T, 1, 1>(x, g, ypos, dx, partial, gy, n,
                                           t_in, t_out, v, c, rows, s);
  }
  return vec ? backward_outputs<T, 2, kVec>(x, g, ypos, dx, partial, gy, n,
                                            t_in, t_out, v, c, rows, s)
             : backward_outputs<T, 2, 1>(x, g, ypos, dx, partial, gy, n,
                                         t_in, t_out, v, c, rows, s);
}

}  // namespace

extern "C" int temporal_shift_forward(const void* x, const void* ypos,
                                      void* out, int n, int t_in, int t_out,
                                      int v, int c, int stride, int is_bf16,
                                      void* stream) {
  if (stride != 1 && stride != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || t_out == 0 || v == 0 || c == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? forward_dispatch<__nv_bfloat16>(x, ypos, out, n, t_in, t_out,
                                                v, c, stride, s)
              : forward_dispatch<float>(x, ypos, out, n, t_in, t_out, v, c,
                                        stride, s));
}

// Rows of the partial-sum scratch that temporal_shift_backward may need
// for gy_raw: one per tile, at most n * ceil(t_in / kMinRun).
extern "C" int temporal_shift_backward_rows(int n, int t_in) {
  return n * ((t_in + kMinRun - 1) / kMinRun);
}

// dx (grad_input, may be null), gy (gy_raw, may be null; then partial may
// be null too) from the forward input x (may be null without gy) and the
// cotangent g.  partial: temporal_shift_backward_rows(n, t_in) x c fp32.
extern "C" int temporal_shift_backward(const void* x, const void* g,
                                       const void* ypos, void* dx,
                                       void* partial, void* gy, int n,
                                       int t_in, int t_out, int v, int c,
                                       int stride, int is_bf16,
                                       void* stream) {
  if ((stride != 1 && stride != 2) || (dx == nullptr && gy == nullptr) ||
      (gy != nullptr && (x == nullptr || partial == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rows = 0;
  if (n > 0 && t_in > 0 && v > 0) {
    const cudaError_t err =
        is_bf16 ? backward_dispatch<__nv_bfloat16>(x, g, ypos, dx, partial,
                                                   gy != nullptr, n, t_in,
                                                   t_out, v, c, stride, &rows,
                                                   s)
                : backward_dispatch<float>(x, g, ypos, dx, partial,
                                           gy != nullptr, n, t_in, t_out, v,
                                           c, stride, &rows, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (gy == nullptr) return 0;
  tshift_position_final_kernel<<<(c + kLaneCh - 1) / kLaneCh,
                                 dim3(kLaneCh, kFinalRows), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(gy), rows, c,
      static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}
