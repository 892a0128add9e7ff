// Fused spatial Shift-GCN transform: forward (K4), input gradient (K5)
// and the weight gradients (K6).
//
// Replaces the Pallas TPU kernels of the reference package,
// ops/pallas/shift_gcn_kernel.py: _fwd_kernel reached through
// fused_shift_gcn / _run_fwd (K4), the same kernel reached through
// _run_dx for the input gradient (K5), and _shear_gate_kernel reached
// through _run_shear_gate from the backward, with the XLA einsums of
// _fused_bwd that consume it (K6).  For x (R, V, C), gate (V, C),
// W (C, D), bias (D):
//
//   h[r, u, c]   = x[r, (u + c) % V, c] * gate[u, c]       (shear in, gate)
//   z[r, u, d]   = sum_c h[r, u, c] * W[c, d] + bias[d]
//   out[r, w, d] = z[r, (w - d) % V, d]                     (shear out)
//
// Under tensor parallelism a rank holds output channels [d0, d0 + D) of
// a wider layer: W and bias are its column slice, and every shear on the
// d axis indexes the global channel d0 + d (K4's shear out, K5's and
// K6's shear in of the cotangent).  The shears on the c axis stay as
// they are: the rank holds every input channel.  d0 = 0 is the unsharded
// layer, and the kernels then do exactly what they did without d0.
//
// K5, for the cotangent g (R, V, D):
//
//   dz[r, u, c]  = sum_d g[r, (u + d) % V, d] * W[c, d]
//   dx[r, w, c]  = dz[r, u, c] * gate[u, c],  u = (w - c) % V
//
// K6, from the per-joint product over all frames
//
//   M[u, c, d]   = sum_r x[r, (u + c) % V, c] * g[r, (u + d) % V, d]
//   dW[c, d]     = sum_u gate[u, c] * M[u, c, d]
//   dgate[u, c]  = sum_d M[u, c, d] * W[c, d]
//   dbias[d]     = sum_{r, v} g[r, v, d]   (the shear permutes a frame)
//
// dgate comes from the ungated shear, never as h / gate.
//
// fp32 accumulation; x and g (and K4/K5's outputs) are fp32 or bf16,
// gate/W/bias and K6's outputs fp32.
//
// Bound on the H100.  K4 and K5 do 2*R*V*C*D flops on the tensor cores
// with fp32 accuracy (3xTF32: three TF32 products per multiply-add, so
// 495 / 3 = 165 TFLOP/s) and move (R*V*C + R*V*D) activations once.  The
// larger of the two times is the bound: at the forward's shapes the
// operations term for C, D >= 128 and the bytes term for the narrow
// layers (C=3, and D=64 at bf16 I/O).  K6 does the same 2*R*V*C*D flops
// on the same two activations, so its bound is K4's at the same shapes.
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
// Wide tiles (kWide, V > kRows: a whole-body skeleton, 543 joints for
// MediaPipe Holistic): a frame no longer fits a tile, so a tile is kRows
// consecutive joints [u0, u0 + 144) of one frame, ceil(V / 144) tiles a
// frame, with the same fragments, mma and warp grid.  For a k-slice from
// channel k0 (global from d0 for K5), row u and channel k0 + kk read
// joint (u + k0 + kk) % V, so the slab is the window of 144 + 31 = 175
// joints from (u0 + k0) % V, staged as it wraps at V; row m, channel kk
// reads slot m + kk with no wrap.  K4 stages the gate rows of the tile's
// joints only.  The epilogue stores a part of a frame: output row w gets
// from the tile the channels whose source joint (w - d') % V lies in
// [u0, u0 + 144), a contiguous run a row; a thread's 16-byte chunk whose
// elements all lie in the tile is one vector store, the ragged ends are
// stored one by one, and every output is written by exactly one tile of
// its frame (store_tile_wide).  No atomics, so two launches are bit-equal.
// Shared memory does not grow with V: K4 fp32 202,720 B (128-column
// tile), bf16 180,320 B.  The 175-row window re-reads 31 of every 144
// slab rows, and the gate is staged per tile: a first design, right
// before fast.
//
// K6 design: for each joint u, M[u] is a (C x D) product over a very deep
// K (R up to 19200 frames) with tiny M and N, so the reduction over R is
// split across blocks.  One launch is two kernels:
//   partial  block (frame chunk p, joint group, 32-channel c tile,
//            32-channel d tile); 11 warps at most, each owning up to 3
//            joints of the group (33 joints a group: the whole frame at
//            V <= 33) and their 32 x 32 M tiles in registers (96 fp32
//            accumulators a thread).  Each stage stages kF frames (8
//            fp32, 16 bf16) of the x c tile and the g d tile into a
//            2-stage ring, so the slabs are read from device memory once
//            per (tile pair) and hold every joint's diagonal; the shear
//            is applied when a warp loads its fragments from the slab.
//            Each staged element feeds exactly one joint, so it is loaded
//            and split once, in registers.  mma.sync with fp32
//            accumulation, M = c, N = d, K = frames: fp32 inputs run
//            m16n8k8 TF32 three times a k8 step (small*big, big*small,
//            big*big, as K4); bf16 inputs run one m16n8k16 bf16 mma a
//            stage (products exact in fp32), a register packing two
//            frames.  The tensor cores' fp32 accumulator does not round
//            to nearest (it drops low bits, biased toward zero: a first
//            build that accumulated a whole chunk of up to 2400 frames in
//            it was off its plain version by up to 1.9e-5 of scale in
//            fp32, growing with the chunk), so each warp sums one
//            stage's products per joint from zero and adds them to its
//            accumulators in fp32.  Every warp runs all its joints and
//            tiles without a branch (a tile past C or D multiplies zeros,
//            a missing joint repeats joint 0, and the epilogue drops
//            both): with the branches each tile was a basic block of its
//            own, which kept loads from being hoisted, and fp32 ran about
//            a third slower.  The epilogue forms the block's share of
//            dgate (its joints, its d tile: sum over d of M * W, the four
//            lanes of a quad summed in a fixed butterfly), of dW (sum
//            over its joints of gate * M, per warp, then over the warps
//            in order) and, in the blocks of c tile 0, of dbias (the B
//            values summed as they are loaded), into scratch.  No M is
//            written out.
//   final    sums the partials in a fixed order: over the frame chunks
//            and then the joint groups (dW, dbias) or d tiles (dgate).
// No floating-point atomics: two launches on one input are bit-equal.
// The split of R (parts, frames a chunk) is chosen by the wrapper from
// the shapes alone, so the summation order does not depend on the card.
// Bound: as K4 (the operations term for the wide layers).  The 32 x 32
// tile is the accumulator limit at 33 joints (96 of the 168 registers a
// thread can have at 11 warps).  The blocks re-read each x slab D/32
// times and each g slab C/32 times from L2 (the blocks of one chunk run
// side by side), and that staging, not the tensor cores or the fragment
// build, sets the kernel's time on an H100.
//
// One joint group (V <= 33, the shipped skeletons): a stage holds kF
// whole frames, [frame][row][32], rows 32 elements and each frame padded
// by 8 (fragment reads free of bank conflicts in fp32, 2-way in bf16),
// copied by every warp with 16-byte cp.async as they lie, then
// multiplied; about one wave of blocks (~132).  Joint uu, channel cc reads
// staged row uu + cc (mod V).  13.8 GB staged a fp32 step at 64 clips; a
// third ring stage, or one bulk copy a staged row, did not speed it up.
//
// Joint groups (V > 33, e.g. 543 for MediaPipe Holistic): groups of
// ceil(V / ceil(V / 33)) joints.  A group's joints u0 + uu, channel
// c0 + cc read rows (u0 + c0 + uu + cc) % V: a parallelogram of rows x
// channels.  Its bounding window, joints + 31 full rows, holds 2x the
// rows used and leaves room for one stage only; and one wave of blocks
// leaves half the SMs idle or a ragged second wave (68 blocks at V = 543,
// (T, C, D) = (300, 64, 64)).  So:
//  - strips: the c tile is cut into 32-byte sectors (kW = 8 fp32 or 16
//    bf16 channels), and strip k holds only the rows its channels read,
//    joints + kW - 1 of them (made odd) from (u0 + c0 + k kW) % V;
//    [strip][frame][row][kW], strips 128-byte aligned.  Joint uu, channel
//    cc reads strip cc / kW at row uu + cc % kW.  Frames are rows * kW
//    apart, 8 or 24 mod 32 words: the fp32 fragment reads are free of
//    bank conflicts, bf16's 2-way at most.  34.7 GB staged a fp32 step
//    at V = 543, 8 clips (20.9 GB bf16), against 56.0 (28.0) for the
//    window.  Two stages fit whatever V: 159,760 B fp32, 192,528 B bf16
//    at 32 joints.
//  - tensor copies: a strip of a stage is one TMA box (kW channels, its
//    rows, kF frames) of a tensor map over (R, V, n), issued by one
//    thread and completing on the stage's mbarrier, where it does not
//    wrap at V and the rows are 16-byte aligned; frames past R read zero
//    as out of bounds, and chunks are whole stages, so a box never reads
//    another chunk's frames.  The wrapping strips (about rows / V of
//    them) and unaligned inputs (unit 1's C = 3) take 16-byte cp.async
//    by every warp (4-byte copies and scalar bf16 stores where rows are
//    not 16-byte multiples).  Measured at V = 543, a step's launches at 8
//    clips, fp32 / bf16 (scripts/k6_variants.py, H100 SXM): every warp
//    copying the strips with cp.async, then multiplying, 16.96 / 9.56
//    ms; the tensor copies 11.45 / 7.58 ms, of which the copy alone takes
//    10.36 / 7.17 and the multiply alone 7.21 / 4.22, so the staging from
//    L2 (~3 TB/s) still sets the time.  One producer warp issuing every
//    cp.async while the others multiply was several times slower: one
//    warp cannot issue the copies.  A third stage (30 joints a group, to
//    fit) read 13.55 ms, TF32 splits by truncation 11.25: not kept.
//  - waves: the wrapper picks the chunk (whole 16-frame stages) whose
//    waves of 132 blocks, one block an SM, take the least time, among
//    those that leave under 10% of the last wave idle.  Scratch grows
//    with the parts: at V = 543, 64 clips, (300, 64, 64) 25 parts,
//    3.5 M floats (14 MB).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, bool kDx, int kBN, bool kWide>
struct Layout {
  // slab rows a stage holds: the tile's whole frames as they lie, or
  // (kWide) the wrapped window of kRows + kK - 1 joints that the tile's
  // sheared rows read
  static constexpr int kSlabRows = kWide ? kRows + kK - 1 : kRows;
  static constexpr int kSlabBytes = kSlabRows * slab_ld<T>() * sizeof(T);
  static constexpr int kWBytes = (kDx ? kBN * (kK + 4) : kK * (kBN + 8)) * 4;
  static constexpr int kFragABytes = kRows / 16 * kK8 * 32 * 16;  // per plane
  static constexpr int kFragBBytes = kBN / 8 * kK8 * 32 * 16;
  static constexpr int kZBytes = kRows * (kBN + 4) * 4;
  static constexpr int kFragBytes = 2 * kFragABytes + kFragBBytes;
  static constexpr int kRegionBytes = kFragBytes > kZBytes ? kFragBytes
                                                           : kZBytes;
  // K4's gate slice: V rows, or (kWide) the tile's kRows joints
  __host__ __device__ static int stage_bytes(int v) {
    return kSlabBytes + kWBytes + (kDx ? 0 : (kWide ? kRows : v) * kLdg * 4);
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

// bf16 inputs: D += A * B, products exact in fp32, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// the two bf16 values of a packed pair, widened to fp32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t pair) {
  return __uint_as_float(pair << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

// Store the tile's rows of z (staged in zs) with the out-shear folded in:
// out[r, w, n] = zs[f*V + (w - n') % V][n], n' = d0 + n (K4's global
// output channel) or n (K5: the input channels, all held), times
// gate[(w - n) % V, n] for K5.  Each thread owns one kVec-column chunk
// and walks the rows.
template <typename T, bool kDx, int kBN, int kVec>
__device__ __forceinline__ void store_tile(const float* zs, T* out,
                                           const float* gate,
                                           int64_t row0, int rows, int v,
                                           int n0, int n, int d0) {
  constexpr int kLdz = kBN + 4;
  constexpr int kChunks = kBN / kVec;
  constexpr int kStep = kMmaThreads / kChunks;
  static_assert(kMmaThreads % kChunks == 0, "store walk");
  const int j = threadIdx.x % kChunks;
  const int col = n0 + j * kVec;
  if (col >= n) return;  // n % kVec == 0 on the vector path
  int nm[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) nm[e] = ((kDx ? 0 : d0) + col + e) % v;
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

// The same for a wide tile (V > kRows): zs holds joints [u0, u0 + rows) of
// the frame at row0.  Output (w, n) reads z at joint (w - n') % V, so this
// tile writes the outputs whose source row q - e (mod V) lies below rows,
// where w = (u0 + col' + q) % V and column col + e; every other tile of
// the frame writes the rest, each output once.  Each thread owns one
// kVec-column chunk and walks its q over [0, min(V, rows + kVec - 1)),
// distinct rows w: a chunk wholly in the tile is one vector store, the
// ragged ends are stored element by element.
template <typename T, bool kDx, int kBN, int kVec>
__device__ __forceinline__ void store_tile_wide(const float* zs, T* out,
                                                const float* gate,
                                                int64_t row0, int u0,
                                                int rows, int v, int n0,
                                                int n, int d0) {
  constexpr int kLdz = kBN + 4;
  constexpr int kChunks = kBN / kVec;
  constexpr int kStep = kMmaThreads / kChunks;
  static_assert(kMmaThreads % kChunks == 0, "store walk");
  const int j = threadIdx.x % kChunks;
  const int col = n0 + j * kVec;
  if (col >= n) return;  // n % kVec == 0 on the vector path
  const int w0 = (u0 + ((kDx ? 0 : d0) + col) % v) % v;
  const int span = min(v, rows + kVec - 1);
  auto value = [&](int m, int e) {
    float val = zs[m * kLdz + j * kVec + e];
    if (kDx) val *= __ldg(gate + (u0 + m) * n + col + e);
    return val;
  };
  for (int q = threadIdx.x / kChunks; q < span; q += kStep) {
    int w = w0 + q;
    w -= w >= v ? v : 0;
    T* dst = out + (row0 + w) * n + col;
    if (q >= kVec - 1 && q < rows) {
      float vals[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = value(q - e, e);
      if constexpr (kVec > 1) {
        store_vec(dst, vals);
      } else {
        store_f(dst, vals[0]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        int m = q - e;
        m += m < 0 ? v : 0;
        if (m < rows) store_f(dst + e, value(m, e));
      }
    }
  }
}

// Persistent: block b takes tiles b, b + gridDim.x, ...; a tile is
// (frames whole frames, kBN output channels), the column tile the faster
// index; kWide (V > kRows): (kRows joints of one frame, kBN output
// channels), `frames` then the tiles of one frame.  kDx=false: K4, x
// (R, V, kdim) is the input, w (kdim, n) row-major, gate (V, kdim) on the
// input side, bias added.  kDx=true: K5,
// x is the cotangent (R, V, kdim) with kdim = D of the forward, w is the
// forward's (n, kdim) array read transposed, gate (V, n) multiplies the
// output at its source joint, no bias.  vec_x / vec_w / vec_g / vec_out:
// the 16-byte paths apply (row lengths and base pointers allow them).
// d0: the global index of output channel 0 of the forward (K4's n axis,
// K5's kdim axis), which the shears on that axis read.
template <typename T, bool kDx, int kBN, bool kWide>
__global__ void __launch_bounds__(kMmaThreads,
                                  kDx && kBN == 64 && !kWide ? 2 : 1)
shift_gcn_mma_kernel(const T* __restrict__ x, const float* __restrict__ gate,
                     const float* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int r_total, int v, int kdim, int n, int frames,
                     int col_tiles, int tiles, int d0, bool vec_x,
                     bool vec_w, bool vec_g, bool vec_out) {
  using L = Layout<T, kDx, kBN, kWide>;
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
    const int n0 = (tile % col_tiles) * kBN;
    unsigned char* base = stage_base(p);
    T* xs = reinterpret_cast<T*>(base);
    float* ws = reinterpret_cast<float*>(base + L::kSlabBytes);
    int u0 = 0;  // kWide: the tile's first joint
    if constexpr (kWide) {
      // slot s holds joint (first + s) % V of the tile's frame, first the
      // joint that row 0 reads at channel k0 (global from d0 for K5)
      const int rt = tile / col_tiles;
      const int f = rt / frames;
      u0 = (rt - f * frames) * kRows;
      const int first = (u0 + (kDx ? d0 % v : 0) + k0) % v;
      const T* xf = x + static_cast<int64_t>(f) * v * kdim;
      if (vec_x) {
        constexpr int kChunks = kK / kVecX;
        for (int l = tid; l < L::kSlabRows * kChunks; l += kMmaThreads) {
          const int m = l / kChunks;
          const int j = l % kChunks;
          const int ch = k0 + j * kVecX;
          const bool in = ch < kdim;
          const int64_t row = (first + m) % v;
          cp_async16(xs + m * kLda + j * kVecX,
                     in ? xf + row * kdim + ch : x, in);
        }
      } else {
        for (int l = tid; l < L::kSlabRows * kK; l += kMmaThreads) {
          const int m = l / kK;
          const int kk = l % kK;
          const int ch = k0 + kk;
          const int64_t row = (first + m) % v;
          if constexpr (sizeof(T) == 4) {
            const bool in = ch < kdim;
            cp_async4(xs + m * kLda + kk, in ? xf + row * kdim + ch : x,
                      in);
          } else {
            xs[m * kLda + kk] = ch < kdim ? xf[row * kdim + ch]
                                          : zero_of<T>();
          }
        }
      }
    } else {
      const int r0 = (tile / col_tiles) * frames;
      const int rows = min(frames, r_total - r0) * v;
      const T* xb = x + static_cast<int64_t>(r0) * v * kdim;
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
      // gs[u][kk] = gate[u, k0 + kk]; kWide: gate[u0 + u, k0 + kk], zero
      // past the frame's last joint
      float* gs = reinterpret_cast<float*>(base + L::kSlabBytes + L::kWBytes);
      if constexpr (kWide) {
        const float* gt = gate + static_cast<int64_t>(u0) * kdim;
        const int grows = min(kRows, v - u0);
        if (vec_g) {
          for (int l = tid; l < kRows * (kK / 4); l += kMmaThreads) {
            const int u = l / (kK / 4);
            const int j = l % (kK / 4);
            const int ch = k0 + 4 * j;
            const bool in = ch < kdim && u < grows;
            cp_async16(gs + u * kLdg + 4 * j, in ? gt + u * kdim + ch : gate,
                       in);
          }
        } else {
          for (int l = tid; l < kRows * kK; l += kMmaThreads) {
            const int u = l / kK;
            const int kk = l % kK;
            const bool in = k0 + kk < kdim && u < grows;
            cp_async4(gs + u * kLdg + kk, in ? gt + u * kdim + k0 + kk : gate,
                      in);
          }
        }
      } else if (vec_g) {
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
      if constexpr (kWide) {
        // row m reads slots m + kk: its window starts at slot m
        a_fbase[i][h] = m * kLda;
        a_u[i][h] = m;
      } else {
        const int f = m < frames * v ? m / v : 0;
        a_fbase[i][h] = f * v * kLda;
        a_u[i][h] = m < frames * v ? m - f * v : 0;
      }
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
    const int n0 = (tile % col_tiles) * kBN;
    // kWide: frame r0 (its first row r0 * V), joints [u0, u0 + rows)
    int r0, rows, u0 = 0;
    if constexpr (kWide) {
      const int rt = tile / col_tiles;
      r0 = rt / frames;
      u0 = (rt - r0 * frames) * kRows;
      rows = min(kRows, v - u0);
    } else {
      r0 = (tile / col_tiles) * frames;
      rows = min(frames, r_total - r0) * v;
    }
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
      // K5's k axis is the forward's output channels: global from d0
      const int c_lo = (kDx ? d0 : 0) + k0 + a_kk_lo;
      const int cm_lo = c_lo % v;  // channel mod V, once per stage
      const int cm_hi = (c_lo + 4) % v;
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        float a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q & 1;  // a0, a2: row g; a1, a3: row g + 8
          const int hi = q >> 1;
          float val;
          if constexpr (kWide) {
            // the window wraps at V as it is staged: row m, channel kk
            // reads slot m + kk
            const int kk = a_kk_lo + 4 * hi;
            val = load_f(xs + a_fbase[i][h] + kk * (kLda + 1));
          } else {
            int s = a_u[i][h] + (hi ? cm_hi : cm_lo);
            s -= s >= v ? v : 0;
            val = load_f(xs + a_fbase[i][h] + s * kLda + a_kk_lo + 4 * hi);
          }
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
    if constexpr (kWide) {
      if (vec_out) {
        store_tile_wide<T, kDx, kBN, vec_elems<T>()>(
            zs, out, gate, row0, u0, rows, v, n0, n, d0);
      } else {
        store_tile_wide<T, kDx, kBN, 1>(zs, out, gate, row0, u0, rows, v,
                                        n0, n, d0);
      }
    } else if (vec_out) {
      store_tile<T, kDx, kBN, vec_elems<T>()>(zs, out, gate, row0, rows, v,
                                              n0, n, d0);
    } else {
      store_tile<T, kDx, kBN, 1>(zs, out, gate, row0, rows, v, n0, n, d0);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// K6: the weight gradients (see the design note at the top)
// ---------------------------------------------------------------------------

constexpr int kWgTile = 32;       // channels of a c tile and of a d tile
constexpr int kWgJoints = 3;      // joints a warp
constexpr int kWgMaxWarps = 11;
constexpr int kWgGroup = kWgMaxWarps * kWgJoints;  // joints a block, at most
constexpr int kWgLd = 32;         // staged row stride, elements
constexpr int kWgFramePad = 8;    // elements after each staged frame
constexpr int kWgRedLd = kWgTile + 1;
constexpr int kWgFinalThreads = 256;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block, sm_90

// frames a pipeline stage: one mma k step, k8 TF32 (fp32) or k16 (bf16)
template <typename T>
__host__ __device__ constexpr int wg_frames() {
  return sizeof(T) == 4 ? 8 : 16;
}
// channels a strip row (groups > 1): one 32-byte sector, 8 fp32 or 16 bf16
template <typename T>
__host__ __device__ constexpr int wg_strip() {
  return 32 / static_cast<int>(sizeof(T));
}
constexpr int kWgStages = 2;  // ring stages

// tensor maps of x and g for the strips path's tensor copies
struct WgradMaps {
  CUtensorMap x, g;
};

struct WgradGeom {
  int r, v, c, d;
  int d_global;                // global index of output channel 0 (d0)
  int groups, joints;          // joint groups, joints a group
  int rows;                    // rows a staged frame: window or strip rows
  int fs;                      // staged frame stride, elements
  int ss;                      // staged strip stride (strips), elements
  bool tma_x, tma_g;           // strips by tensor copies (maps below)
  int c_tiles, d_tiles;
  int parts, chunk;            // frame chunks, frames a chunk
  int warps;
  bool vec_x, vec_g;
};

// Scratch (fp32): dW partials [parts][groups][C][D], then dgate partials
// [parts][d_tiles][V][C], then dbias partials [parts][groups][D].
__host__ __device__ inline int64_t wg_dgate_offset(const WgradGeom& s) {
  return static_cast<int64_t>(s.parts) * s.groups * s.c * s.d;
}
__host__ __device__ inline int64_t wg_bias_offset(const WgradGeom& s) {
  return wg_dgate_offset(s) +
         static_cast<int64_t>(s.parts) * s.d_tiles * s.v * s.c;
}
__host__ __device__ inline int64_t wg_scratch(const WgradGeom& s) {
  return wg_bias_offset(s) + static_cast<int64_t>(s.parts) * s.groups * s.d;
}
__host__ __device__ inline int64_t wg_blocks(const WgradGeom& s) {
  return static_cast<int64_t>(s.parts) * s.groups * s.c_tiles * s.d_tiles;
}

// Copy kF frames (from f0; frames at or past f_end read zero) of the
// window rows (base + slot) % V, slot < window, channels [ch0, ch0 + 32)
// of src (R, V, n) into dst [frame][slot][kWgLd], frames s.fs apart.
// Channels past n and the frame pads are never written: the ring is zeroed
// once.  Lanes run along a row's pieces (16-byte vectors, or elements);
// each thread keeps its piece and steps its (frame, slot) without a
// division.
template <typename T>
__device__ __forceinline__ void wg_stage(const T* __restrict__ src, T* dst,
                                         int f0, int f_end, int base,
                                         int ch0, int n, const WgradGeom& s,
                                         bool vec) {
  constexpr int kF = wg_frames<T>();
  constexpr int kVec = vec_elems<T>();
  const int width = min(kWgTile, n - ch0);
  const int pieces = vec ? width / kVec : width;  // n % kVec == 0 if vec
  const int step = blockDim.x / pieces;  // rows a pass
  if (static_cast<int>(threadIdx.x) >= step * pieces) return;
  const int j = threadIdx.x % pieces;
  int m = threadIdx.x / pieces;
  int f = m / s.rows;
  int slot = m - f * s.rows;
  const int ch = ch0 + (vec ? j * kVec : j);
  T* out = dst + (vec ? j * kVec : j);
  const int fs = s.fs;
  for (; m < kF * s.rows; m += step) {
    int row = base + slot;
    row -= row >= s.v ? s.v : 0;
    const bool in = f0 + f < f_end;
    const T* from =
        in ? src + (static_cast<int64_t>(f0 + f) * s.v + row) * n + ch : src;
    if (vec) {
      cp_async16(out + f * fs + slot * kWgLd, from, in);
    } else if constexpr (sizeof(T) == 4) {
      cp_async4(out + f * fs + slot * kWgLd, from, in);
    } else {
      out[f * fs + slot * kWgLd] = in ? *from : zero_of<T>();
    }
    slot += step;
    while (slot >= s.rows) {
      slot -= s.rows;
      ++f;
    }
  }
}

// Copy kF frames (from f0; frames at or past f_end read zero) of a joint
// group's strips of src (R, V, n) but those in `skip` (the tensor copies'):
// strip k holds channels [ch0 + k kW, ch0 + (k + 1) kW) of the rows
// (base + k kW + j) % V, j < s.rows, at dst[k ss + f fs + j kW].  A warp
// copies one strip of one frame at a time, its lanes along the strip's
// rows and their 16-byte halves (or elements); channels past n are never
// written (the ring is zeroed once).
template <typename T>
__device__ __forceinline__ void wg_stage_strips(const T* __restrict__ src,
                                                T* dst, int f0, int f_end,
                                                int base, int ch0, int n,
                                                const WgradGeom& s,
                                                bool vec, unsigned skip) {
  constexpr int kF = wg_frames<T>();
  constexpr int kW = wg_strip<T>();
  constexpr int kS = kWgTile / kW;
  constexpr int kVec = vec_elems<T>();
  static_assert(kW == 2 * kVec, "a strip row is two 16-byte copies");
  const int shift = vec ? 1 : (kW == 8 ? 3 : 4);  // log2(copies a row)
  const int items = s.rows << shift;
  const int lane = threadIdx.x & 31;
  for (int unit = threadIdx.x >> 5; unit < kF * kS;
       unit += blockDim.x >> 5) {
    const int f = unit / kS;
    const int k = unit % kS;
    const int ch_k = ch0 + k * kW;
    if (ch_k >= n || (skip >> k & 1u)) continue;
    const bool in = f0 + f < f_end;
    int rb = base + k * kW;  // base < V and k kW <= 24 < V
    rb -= rb >= s.v ? s.v : 0;
    const T* frame =
        src + (in ? static_cast<int64_t>(f0 + f) * s.v * n : 0);
    T* out = dst + k * s.ss + f * s.fs;
    for (int i = lane; i < items; i += 32) {
      const int j = i >> shift;
      const int e = vec ? (i & 1) * kVec : i & (kW - 1);
      if (ch_k + e >= n) continue;
      int row = rb + j;  // rows <= V: one wrap at most
      row -= row >= s.v ? s.v : 0;
      const T* from = in ? frame + row * n + ch_k + e : src;
      T* to = out + j * kW + e;
      if (vec) {
        cp_async16(to, from, in);
      } else if constexpr (sizeof(T) == 4) {
        cp_async4(to, from, in);
      } else {
        *to = in ? *from : zero_of<T>();
      }
    }
  }
}

// The tensor copies (TMA) of the strips path: a strip of kF frames, one
// box (kW channels, s.rows rows, kF frames) of a tensor map over (R, V, n),
// lands in shared memory as [frame][row][channel], completing on an
// mbarrier.  Frames past R read zero (out of bounds).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Waits for the mbarrier's phase `parity` to complete; traps after ~10 s
// (2^34 cycles) without it, so that a lost copy fails the launch rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// kStrips: the joint-group path (V > kWgGroup), staged as strips; else
// the whole frame, staged as a window of V rows.
template <typename T, bool kStrips>
__global__ void __launch_bounds__(kWgMaxWarps * 32, 1)
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ gate,
                     const float* __restrict__ w, float* __restrict__ part,
                     WgradGeom s, const __grid_constant__ WgradMaps maps) {
  constexpr int kF = wg_frames<T>();
  constexpr int kW = wg_strip<T>();
  constexpr int kS = kWgTile / kW;
  constexpr int kStages = kWgStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const int fs = s.fs;
  // elements of one staged slab
  const int slab = kStrips ? kS * s.ss : kF * fs;
  T* ring = reinterpret_cast<T*>(smem);  // slot k: x slab, then g slab
  // the tensor copies' mbarriers, past the ring and the epilogue's sums
  uint64_t* landed = reinterpret_cast<uint64_t*>(
      smem + max(kStages * 2 * slab * static_cast<int>(sizeof(T)),
                 s.warps * kWgTile * (kWgRedLd + 1) * 4));

  int b = blockIdx.x;
  const int dti = b % s.d_tiles;
  b /= s.d_tiles;
  const int cti = b % s.c_tiles;
  b /= s.c_tiles;
  const int jg = b % s.groups;
  const int p = b / s.groups;
  const int u0 = jg * s.joints;
  const int nj = min(s.joints, s.v - u0);
  const int c0 = cti * kWgTile;
  const int d0 = dti * kWgTile;
  const int f_begin = p * s.chunk;
  const int f_end = min(s.r, f_begin + s.chunk);
  const int steps = f_end > f_begin ? (f_end - f_begin + kF - 1) / kF : 0;
  const int base_x = (u0 + c0) % s.v;
  const int base_g = (u0 + s.d_global % s.v + d0) % s.v;
  const bool want_bias = cti == 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  // Strips: the tensor copies take the strips that do not wrap at V, of
  // inputs that allow them (tma_x, tma_g); cp.async the others
  unsigned tma_sx = 0, tma_sg = 0;
  if constexpr (kStrips) {
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int rx = (base_x + k * kW) % s.v;
      const int rg = (base_g + k * kW) % s.v;
      if (s.tma_x && c0 + k * kW < s.c && rx + s.rows <= s.v) tma_sx |= 1u << k;
      if (s.tma_g && d0 + k * kW < s.d && rg + s.rows <= s.v) tma_sg |= 1u << k;
    }
  }
  const uint32_t tma_bytes =
      (__popc(tma_sx) + __popc(tma_sg)) * kW * s.rows * kF * sizeof(T);
  const CUtensorMap* map_x = &maps.x;  // in parameter space
  const CUtensorMap* map_g = &maps.g;

  {  // channels past C / D are never copied: zero the ring once
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n16 = kStages * 2 * slab * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  if (kStrips && tma_bytes) {
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < kStages; ++k) mbar_init(&landed[k], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the zeros, stored through the generic proxy, before any tensor copy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int st, int slot) {
    T* xs = ring + 2 * slot * slab;
    const int f0 = f_begin + st * kF;
    if constexpr (kStrips) {
      if (tid == 0 && tma_bytes) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&landed[slot], tma_bytes);
#pragma unroll
        for (int k = 0; k < kS; ++k) {
          if (tma_sx >> k & 1u)
            tma_load_3d(xs + k * s.ss, map_x, &landed[slot], c0 + k * kW,
                        (base_x + k * kW) % s.v, f0);
          if (tma_sg >> k & 1u)
            tma_load_3d(xs + slab + k * s.ss, map_g, &landed[slot],
                        d0 + k * kW, (base_g + k * kW) % s.v, f0);
        }
      }
      wg_stage_strips(x, xs, f0, f_end, base_x, c0, s.c, s, s.vec_x, tma_sx);
      wg_stage_strips(g, xs + slab, f0, f_end, base_g, d0, s.d, s, s.vec_g,
                      tma_sg);
    } else {
      wg_stage(x, xs, f0, f_end, base_x, c0, s.c, s, s.vec_x);
      wg_stage(g, xs + slab, f0, f_end, base_g, d0, s.d, s, s.vec_g);
    }
  };

  // Window: the staged slot of fragment row / column k of joint uu is
  // uu + k (mod the window); k mod the window is taken once here
  int cm[2][2], dm[4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) cm[mi][h] = (mi * 16 + gq + 8 * h) % s.rows;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) dm[ni] = (ni * 8 + gq) % s.rows;
  // Strips: channel cb + gq (cb a multiple of 8) of joint uu lies in strip
  // (cb + gq) / kW at row uu + (cb + gq) % kW of that strip
  auto strip_at = [&](int cb, int uu) {
    return (cb / kW) * s.ss + (cb % kW) * (kW + 1) + uu * kW + gq * (kW + 1);
  };
  // Every warp runs both m16 tiles and all four n8 tiles, without a
  // branch: a tile past C or D multiplies the ring's zeros, and the
  // epilogue drops its channels.

  // the warp's joints; a warp short of kWgJoints runs joint 0 in the dead
  // slot, so the loop has no branch, and drops that slot's sums
  int uus[kWgJoints];
  bool live[kWgJoints];
#pragma unroll
  for (int jj = 0; jj < kWgJoints; ++jj) {
    const int uu = warp + nw * jj;
    live[jj] = uu < nj;
    uus[jj] = live[jj] ? uu : 0;
  }

  float acc[kWgJoints][2][4][4];
#pragma unroll
  for (int jj = 0; jj < kWgJoints; ++jj)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[jj][mi][ni][q] = 0.0f;
  float bacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  // A ring of kStages: the copies of the next kStages - 1 stages are in
  // flight while one is multiplied.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) issue(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<kStages - 2>();
    if (kStrips && tma_bytes)
      mbar_wait(&landed[st % kStages], (st / kStages) & 1);
    // stage st has landed, and every warp is done with the slot of stage
    // st - 1, which stage st + kStages - 1 takes
    __syncthreads();
    const int next = st + kStages - 1;
    if (next < steps) issue(next, next % kStages);
    cp_async_commit();
    const T* xs = ring + 2 * (st % kStages) * slab;
    const T* gs = xs + slab;
#pragma unroll
    for (int jj = 0; jj < kWgJoints; ++jj) {
      const int uu = uus[jj];
      // this stage's share of the joint's M, summed by the tensor cores
      // from zero, then added to the block's sum in fp32 (see the design
      // note: the tensor cores' accumulator does not round to nearest)
      float sa[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) sa[mi][ni][q] = 0.0f;
      if constexpr (sizeof(T) == 4) {
        // one k8 step: frames tq (k rows t) and tq + 4 (k rows t + 4)
        const int row_lo = tq * fs;
        const int row_hi = row_lo + 4 * fs;
        // B = the sheared cotangent: b0 = B[t][g], b1 = B[t + 4][g]
        uint32_t bbig[4][2], bsmall[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          int at;
          if constexpr (kStrips) {
            at = strip_at(ni * 8, uu);
          } else {
            int sl = uu + dm[ni];
            sl -= sl >= s.rows ? s.rows : 0;
            at = sl * kWgLd + ni * 8 + gq;
          }
          const float v0 = gs[row_lo + at];
          const float v1 = gs[row_hi + at];
          if (want_bias && live[jj]) bacc[ni] += v0 + v1;
          split(v0, bbig[ni][0], bsmall[ni][0]);
          split(v1, bbig[ni][1], bsmall[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // A = the sheared input, rows c: a0 (g, t), a1 (g + 8, t),
          // a2 (g, t + 4), a3 (g + 8, t + 4)
          uint32_t abig[4], asmall[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int h = q & 1;
            int at;
            if constexpr (kStrips) {
              at = strip_at(mi * 16 + 8 * h, uu);
            } else {
              int sl = uu + cm[mi][h];
              sl -= sl >= s.rows ? s.rows : 0;
              at = sl * kWgLd + mi * 16 + gq + 8 * h;
            }
            split(xs[(q >> 1 ? row_hi : row_lo) + at], abig[q], asmall[q]);
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            float(&c)[4] = sa[mi][ni];
            mma_tf32(c, asmall[0], asmall[1], asmall[2], asmall[3],
                     bbig[ni][0], bbig[ni][1]);
            mma_tf32(c, abig[0], abig[1], abig[2], abig[3], bsmall[ni][0],
                     bsmall[ni][1]);
            mma_tf32(c, abig[0], abig[1], abig[2], abig[3], bbig[ni][0],
                     bbig[ni][1]);
          }
        }
      } else {
        // one m16n8k16 step over the stage's 16 frames, k index j = frame
        // j: a register packs the pair of frames (2t, 2t + 1) or
        // (2t + 8, 2t + 9), the lower frame in the low half
        const uint16_t* xh = reinterpret_cast<const uint16_t*>(xs);
        const uint16_t* gh = reinterpret_cast<const uint16_t*>(gs);
        const int row_lo = 2 * tq * fs;
        const int row_hi = row_lo + 8 * fs;
        auto pair = [&](const uint16_t* slab_h, int at) {
          const uint32_t lo = slab_h[at];
          const uint32_t hi = slab_h[at + fs];
          return lo | (hi << 16);
        };
        // B = the sheared cotangent: b0 = B[2t, 2t + 1][g],
        // b1 = B[2t + 8, 2t + 9][g]
        uint32_t bq[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          int at;
          if constexpr (kStrips) {
            at = strip_at(ni * 8, uu);
          } else {
            int sl = uu + dm[ni];
            sl -= sl >= s.rows ? s.rows : 0;
            at = sl * kWgLd + ni * 8 + gq;
          }
          bq[ni][0] = pair(gh, row_lo + at);
          bq[ni][1] = pair(gh, row_hi + at);
          if (want_bias && live[jj])
            bacc[ni] += (bf16_lo(bq[ni][0]) + bf16_hi(bq[ni][0])) +
                        (bf16_lo(bq[ni][1]) + bf16_hi(bq[ni][1]));
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // A = the sheared input, rows c: a0 (g, 2t..), a1 (g + 8, 2t..),
          // a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)
          uint32_t a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int h = q & 1;
            int at;
            if constexpr (kStrips) {
              at = strip_at(mi * 16 + 8 * h, uu);
            } else {
              int sl = uu + cm[mi][h];
              sl -= sl >= s.rows ? s.rows : 0;
              at = sl * kWgLd + mi * 16 + gq + 8 * h;
            }
            a[q] = pair(xh, (q >> 1 ? row_hi : row_lo) + at);
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(sa[mi][ni], a[0], a[1], a[2], a[3], bq[ni][0],
                     bq[ni][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[jj][mi][ni][q] += sa[mi][ni][q];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue reuses it

  // accumulator q of acc[jj][mi][ni]: channel c0 + mi*16 + gq + 8*(q >> 1),
  // output channel d0 + ni*8 + 2*tq + (q & 1)
  constexpr unsigned kAll = 0xffffffffu;
  float* dgate_part = part + wg_dgate_offset(s);
  // dgate: per joint, sum over the tile's d of M * W; the quad's four
  // lanes (its d columns) summed in a fixed butterfly
#pragma unroll
  for (int jj = 0; jj < kWgJoints; ++jj) {
    if (!live[jj]) break;
    const int uu = uus[jj];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + mi * 16 + gq + 8 * h;
        float val = 0.0f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = d0 + ni * 8 + 2 * tq + e;
            const float wv = c < s.c && d < s.d ? __ldg(w + c * s.d + d)
                                                : 0.0f;
            val += acc[jj][mi][ni][2 * h + e] * wv;
          }
        }
        val += __shfl_xor_sync(kAll, val, 1);
        val += __shfl_xor_sync(kAll, val, 2);
        if (tq == 0 && c < s.c)
          dgate_part[((static_cast<int64_t>(p) * s.d_tiles + dti) * s.v +
                      u0 + uu) * s.c + c] = val;
      }
    }
  }
  // dW: per warp, sum over its joints of gate * M; dbias: per warp, the
  // quad's frames summed in a fixed butterfly; both then over the warps
  float* red = reinterpret_cast<float*>(smem);  // [warp][32][kWgRedLd]
  float* red_b = red + nw * kWgTile * kWgRedLd;  // [warp][32]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cl = mi * 16 + gq + 8 * h;
      float gv[kWgJoints];
#pragma unroll
      for (int jj = 0; jj < kWgJoints; ++jj)
        gv[jj] = live[jj] && c0 + cl < s.c
                     ? __ldg(gate + (u0 + uus[jj]) * s.c + c0 + cl)
                     : 0.0f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sum = 0.0f;
#pragma unroll
          for (int jj = 0; jj < kWgJoints; ++jj)
            sum += gv[jj] * acc[jj][mi][ni][2 * h + e];
          red[(warp * kWgTile + cl) * kWgRedLd + ni * 8 + 2 * tq + e] = sum;
        }
      }
    }
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    float val = bacc[ni];
    val += __shfl_xor_sync(kAll, val, 1);
    val += __shfl_xor_sync(kAll, val, 2);
    if (tq == 0) red_b[warp * kWgTile + ni * 8 + gq] = val;
  }
  __syncthreads();
  float* dw_part =
      part + (static_cast<int64_t>(p) * s.groups + jg) * s.c * s.d;
  for (int e = tid; e < kWgTile * kWgTile; e += blockDim.x) {
    const int cl = e / kWgTile;
    const int dl = e % kWgTile;
    if (c0 + cl >= s.c || d0 + dl >= s.d) continue;
    float sum = red[cl * kWgRedLd + dl];
    for (int k = 1; k < nw; ++k)
      sum += red[(k * kWgTile + cl) * kWgRedLd + dl];
    dw_part[(c0 + cl) * s.d + d0 + dl] = sum;
  }
  if (want_bias && tid < kWgTile && d0 + tid < s.d) {
    float sum = red_b[tid];
    for (int k = 1; k < nw; ++k) sum += red_b[k * kWgTile + tid];
    part[wg_bias_offset(s) + (static_cast<int64_t>(p) * s.groups + jg) * s.d +
         d0 + tid] = sum;
  }
}

// Sum the partials in a fixed order: dW and dbias over (chunk, joint
// group), dgate over (chunk, d tile).
__global__ void __launch_bounds__(kWgFinalThreads)
wgrad_final_kernel(const float* __restrict__ part, float* __restrict__ dgate,
                   float* __restrict__ dw, float* __restrict__ dbias,
                   WgradGeom s) {
  const int64_t ncd = static_cast<int64_t>(s.c) * s.d;
  const int64_t nvc = static_cast<int64_t>(s.v) * s.c;
  const int64_t total = ncd + nvc + s.d;
  const float* dg_part = part + wg_dgate_offset(s);
  const float* b_part = part + wg_bias_offset(s);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kWgFinalThreads) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * kWgFinalThreads) {
    float sum = 0.0f;
    if (i < ncd) {
      for (int k = 0; k < s.parts * s.groups; ++k) sum += part[k * ncd + i];
      dw[i] = sum;
    } else if (i < ncd + nvc) {
      const int64_t j = i - ncd;
      for (int k = 0; k < s.parts * s.d_tiles; ++k)
        sum += dg_part[k * nvc + j];
      dgate[j] = sum;
    } else {
      const int64_t j = i - ncd - nvc;
      for (int k = 0; k < s.parts * s.groups; ++k)
        sum += b_part[k * s.d + j];
      dbias[j] = sum;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One launch of the template: r frames of v joints, kdim input channels,
// n output channels; as many persistent blocks as the SMs hold (at most
// one per tile).  A tile is kRows / v whole frames, or (kWide) kRows
// joints of one frame, ceil(v / kRows) tiles a frame.
template <typename T, bool kDx, int kBN, bool kWide>
int launch_tile(const void* x, const void* gate, const void* w,
                const void* bias, void* out, int r, int v, int kdim, int n,
                int d0, void* stream) {
  auto kernel = shift_gcn_mma_kernel<T, kDx, kBN, kWide>;
  const int smem = Layout<T, kDx, kBN, kWide>::bytes(v);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int frames = kWide ? (v + kRows - 1) / kRows : kRows / v;
  const int col_tiles = (n + kBN - 1) / kBN;
  const int64_t row_tiles = kWide ? static_cast<int64_t>(r) * frames
                                  : (r + frames - 1) / frames;
  const int64_t tiles = row_tiles * col_tiles;
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
      static_cast<int>(tiles), d0, vec_x, vec_w, vec_g, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDx, bool kWide>
int launch_width(const void* x, const void* gate, const void* w,
                 const void* bias, void* out, int r, int v, int kdim, int n,
                 int d0, void* stream) {
  return n > 64 ? launch_tile<T, kDx, 128, kWide>(x, gate, w, bias, out, r,
                                                  v, kdim, n, d0, stream)
                : launch_tile<T, kDx, 64, kWide>(x, gate, w, bias, out, r, v,
                                                 kdim, n, d0, stream);
}

// whole-frame tiles up to V = kRows, wide tiles past it
template <typename T, bool kDx>
int launch(const void* x, const void* gate, const void* w, const void* bias,
           void* out, int r, int v, int kdim, int n, int d0, void* stream) {
  if (v < 1 || d0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (r == 0 || kdim == 0 || n == 0) return 0;
  return v > kRows ? launch_width<T, kDx, true>(x, gate, w, bias, out, r, v,
                                                kdim, n, d0, stream)
                   : launch_width<T, kDx, false>(x, gate, w, bias, out, r, v,
                                                 kdim, n, d0, stream);
}

// The shape of one K6 launch, but for the staged layout (wg_layout) and
// the 16-byte paths; false if the arguments are out of range.
bool wg_geom(int r, int v, int c, int d, int d0, int parts, int chunk,
             WgradGeom& s) {
  if (v < 1 || c < 1 || d < 1 || d0 < 0 || r < 0 ||
      parts < 1 || chunk < 1 || static_cast<int64_t>(parts) * chunk < r)
    return false;
  s.r = r;
  s.v = v;
  s.c = c;
  s.d = d;
  s.d_global = d0;
  s.groups = (v + kWgGroup - 1) / kWgGroup;
  s.joints = (v + s.groups - 1) / s.groups;
  s.c_tiles = (c + kWgTile - 1) / kWgTile;
  s.d_tiles = (d + kWgTile - 1) / kWgTile;
  s.parts = parts;
  s.chunk = chunk;
  s.warps = (s.joints + kWgJoints - 1) / kWgJoints;
  s.vec_x = s.vec_g = false;
  return wg_blocks(s) <= 0x7fffffff;
}

// The staged layout and the block's dynamic shared memory (two stages of
// an x and a g slab, or the epilogue's reduction, whichever is larger,
// then the strips path's mbarriers).
// One group (V <= kWgGroup): [frame][row][32], the window of V rows, 8
// elements after each frame.  Joint groups: [strip][frame][row][kW],
// kWgTile / kW strips of an odd number >= joints + kW - 1 of rows, each
// strip 128-byte aligned (a tensor copy's box): frames 8 or 24 mod 32
// words apart in fp32, which keeps the fragment loads free of bank
// conflicts (2-way at most in bf16).
template <typename T>
int wg_layout(WgradGeom& s) {
  constexpr int kF = wg_frames<T>();
  if (s.groups == 1) {
    s.rows = s.v;
    s.fs = s.rows * kWgLd + kWgFramePad;
    s.ss = 0;
  } else {
    constexpr int kW = wg_strip<T>();
    constexpr int kLine = 128 / static_cast<int>(sizeof(T));
    s.rows = (s.joints + kW - 1) | 1;  // odd: fs = 8 or 24 mod 32 words
    s.fs = s.rows * kW;
    s.ss = (kF * s.fs + kLine - 1) / kLine * kLine;  // 128-byte aligned
  }
  const int slab = s.groups == 1 ? kF * s.fs : kWgTile / wg_strip<T>() * s.ss;
  const int ring = kWgStages * 2 * slab * static_cast<int>(sizeof(T));
  const int red_bytes = s.warps * kWgTile * (kWgRedLd + 1) * 4;
  // and the strips path's mbarriers
  return (ring > red_bytes ? ring : red_bytes) +
         (s.groups > 1 ? kWgStages * 8 : 0);
}

// A tensor map over src (r, v, n) with boxes of (strip channels, rows,
// stage frames), zero out of bounds; false if cuTensorMapEncodeTiled
// refuses it.
template <typename T>
bool wg_tensor_map(CUtensorMap* map, const void* src, int r, int v, int n,
                   int rows) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t size = sizeof(T);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(v),
                              static_cast<cuuint64_t>(r)};
  const cuuint64_t strides[2] = {n * size, static_cast<cuuint64_t>(v) * n *
                                               size};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(wg_strip<T>()),
                             static_cast<cuuint32_t>(rows),
                             static_cast<cuuint32_t>(wg_frames<T>())};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(src), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch_wgrad(const void* x, const void* g, const void* gate,
                 const void* w, void* partial, int64_t scratch, void* dgate,
                 void* dw, void* dbias, int r, int v, int c, int d, int d0,
                 int parts, int chunk, void* stream) {
  WgradGeom s;
  if (!wg_geom(r, v, c, d, d0, parts, chunk, s))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVec = vec_elems<T>();
  s.vec_x = c % kVec == 0 && aligned16(x);
  s.vec_g = d % kVec == 0 && aligned16(g);
  if (scratch < wg_scratch(s)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = wg_layout<T>(s);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // Joint groups: chunks of whole stages, so that a tensor copy's frames
  // past the chunk are past R (and read zero); tensor maps of the inputs
  // whose rows are 16-byte aligned
  WgradMaps maps;
  s.tma_x = s.tma_g = false;
  if (s.groups > 1 && r > 0) {
    if (chunk % wg_frames<T>() != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    s.tma_x = s.vec_x && wg_tensor_map<T>(&maps.x, x, r, v, c, s.rows);
    s.tma_g = s.vec_g && wg_tensor_map<T>(&maps.g, g, r, v, d, s.rows);
  }
  auto kernel = s.groups > 1 ? wgrad_partial_kernel<T, true>
                             : wgrad_partial_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<static_cast<int>(wg_blocks(s)), s.warps * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(gate), static_cast<const float*>(w),
      static_cast<float*>(partial), s, maps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(c) * d +
                        static_cast<int64_t>(v) * c + d;
  const int64_t want = (total + kWgFinalThreads - 1) / kWgFinalThreads;
  wgrad_final_kernel<<<static_cast<int>(want < 1056 ? want : 1056),
                       kWgFinalThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dgate),
      static_cast<float*>(dw), static_cast<float*>(dbias), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: out (r, v, d) from x (r, v, c), gate (v, c), W (c, d), bias (d);
// d0 the global index of output channel 0 (0 unless W is a column slice).
extern "C" int shift_gcn_forward(const void* x, const void* gate,
                                 const void* w, const void* bias, void* out,
                                 int r, int v, int c, int d, int d0,
                                 int is_bf16, void* stream) {
  return is_bf16 ? launch<__nv_bfloat16, false>(x, gate, w, bias, out, r, v,
                                                c, d, d0, stream)
                 : launch<float, false>(x, gate, w, bias, out, r, v, c, d,
                                        d0, stream);
}

// K5: dx (r, v, c) from the cotangent g (r, v, d), the forward's gate
// (v, c) and W (c, d); d0 as K4's.  Under a column slice dx is this
// slice's part of the input gradient.
extern "C" int shift_gcn_dx(const void* g, const void* gate, const void* w,
                            void* dx, int r, int v, int c, int d, int d0,
                            int is_bf16, void* stream) {
  return is_bf16 ? launch<__nv_bfloat16, true>(g, gate, w, nullptr, dx, r, v,
                                               d, c, d0, stream)
                 : launch<float, true>(g, gate, w, nullptr, dx, r, v, d, c,
                                       d0, stream);
}

// K6: dgate (v, c), dw (c, d), dbias (d), all fp32, from the forward's
// input x (r, v, c), the cotangent g (r, v, d), gate (v, c) and W (c, d);
// d0 as K4's (dgate is then this slice's part).
// R is summed in `parts` chunks of `chunk` frames; `partial` is fp32
// scratch of `scratch` floats, at least shift_gcn_wgrad_scratch(...).
// Two kernels, one launch.
extern "C" int shift_gcn_wgrad(const void* x, const void* g, const void* gate,
                               const void* w, void* partial,
                               long long scratch, void* dgate, void* dw,
                               void* dbias, int r, int v, int c, int d,
                               int d0, int parts, int chunk, int is_bf16,
                               void* stream) {
  return is_bf16 ? launch_wgrad<__nv_bfloat16>(x, g, gate, w, partial,
                                               scratch, dgate, dw, dbias, r,
                                               v, c, d, d0, parts, chunk,
                                               stream)
                 : launch_wgrad<float>(x, g, gate, w, partial, scratch,
                                       dgate, dw, dbias, r, v, c, d, d0,
                                       parts, chunk, stream);
}

// Dynamic shared memory of one K6 block at v joints (fp32 or bf16 inputs).
extern "C" int shift_gcn_wgrad_smem(int v, int is_bf16) {
  WgradGeom s;
  if (!wg_geom(0, v, 1, 1, 0, 1, 1, s)) return -1;
  return is_bf16 ? wg_layout<__nv_bfloat16>(s) : wg_layout<float>(s);
}

// fp32 scratch floats shift_gcn_wgrad needs for these arguments, or -1 if
// it refuses them.
extern "C" long long shift_gcn_wgrad_scratch(int r, int v, int c, int d,
                                             int d0, int parts, int chunk) {
  WgradGeom s;
  return wg_geom(r, v, c, d, d0, parts, chunk, s) ? wg_scratch(s) : -1;
}
