// Train-mode batch normalization: the batch statistics, the normalize
// pass and the fused backward.
//
// Replaces no Pallas kernel: the reference package wrote BN as plain jnp
// (ops/batchnorm.py, _batch_stats :132 and the normalize after it) and
// left it to XLA, which fuses the casts, the two means and the normalize
// into a few passes over the activation.  The port first ran it as some
// nine stock PyTorch ops, each a pass of its own with fp32 intermediates
// saved for autograd; these kernels take their place in training.  Eval
// mode (the running statistics) is not here.
//
// Every layout the model normalizes is a contiguous channels-last tensor
// whose trailing axes are the features, so the kernels take x as a
// row-major (R, F) array: F = C (tcn, residual and down BN), V*C (the
// Shift_gcn bn) or M*V*C (data_bn), R the product of the other axes.
//
// Forward (one launch counted; three passes, four under a process group):
//   stats     per row chunk and feature, sum x and sum x^2 in fp32
//             (bnorm_stats_kernel), then the chunks summed in a fixed order
//             (bnorm_stats_final_kernel): E[x], E[x^2];
//   finish    var = E[x^2] - E[x]^2 (biased), inv = rsqrt(var + eps), the
//             running statistics moved by momentum toward mean and the
//             unbiased var, num_batches_tracked + 1 (unless update is
//             off).  Without a group the final kernel does it; with one,
//             the caller all-reduces (E[x], E[x^2]) and runs
//             bnorm_finish_kernel;
//   normalize y = (x - mean) * inv * w + b in fp32, each step rounded
//             once in that order, output in x's type; with lp (16-bit x)
//             y = x * a + c in x's type, a = inv * w and c = b - mean * a
//             rounded to it (bnorm_normalize_kernel).
// Backward (one launch counted; two passes):
//   sums      per feature sum dy and sum dy * xhat, xhat = (x - mean) * inv
//             recomputed from the saved x, mean and inv (bnorm_grad_sums_
//             kernel, bnorm_grad_final_kernel): db, dw, and their means
//             over the rows, which the caller all-reduces under a group;
//   dx        dx = (w * inv) * ((dy - mean(dy)) - xhat * mean(dy * xhat))
//             (bnorm_grad_input_kernel), skipped where x needs no gradient.
// Nothing of the activation's size is saved in fp32: the backward reads
// x in its own type.
//
// Bound on the H100: a few flops an element against each pass's bytes, so
// BN is bound by memory, its floor the bytes at 3.35 TB/s: forward x read
// twice and y written once, backward x and dy read twice and dx written
// once (16 bytes an element in bf16, 32 in fp32).  The design holds each
// pass to one streaming walk over its tensors:
// - A block is 256 threads, `lanes` along the features by 256 / lanes
//   along the rows.  A lane owns a run of consecutive features, one
//   16-byte vector (4 fp32, 8 bf16 or fp16), so a warp reads whole
//   128-byte lines; lanes is the power of two that covers F's runs, at
//   most 32, and a grid column (a tile) covers lanes runs.  Where F is not
//   a multiple of the vector, or a tensor is not 16-byte aligned, a run is
//   one element.
// - The rows are cut into chunks so that the grid has about 1024 blocks
//   whatever F (~8 a SM, enough loads in flight to hold the bandwidth); a
//   thread walks its chunk's rows with four loads in flight.  The plan
//   (run width, lanes, tiles, chunks) is computed from R and F by the
//   caller (ops/batchnorm.py launch_plan) and checked here.
// - No floating-point atomics: the reductions write one partial row per
//   chunk (each thread sums its rows in order, then the block its row
//   lanes in order), and the final kernels sum the chunks in a fixed
//   order.  So a result depends only on the shapes: two launches are bit
//   for bit equal, which training's reproducibility needs.
// - The elementwise passes round each step (__fmul_rn, __fadd_rn) in the
//   plain version's order, so given the same statistics the output equals
//   the plain PyTorch version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // a pass's block
constexpr int kMaxLanes = 32;     // feature lanes of a block
constexpr int kUnroll = 4;        // rows a thread has in flight
constexpr int kFinalLanes = 32;   // final passes: features x chunk lanes

// ---------------------------------------------------------------------------
// Element I/O: fp32, or 16-bit types moved as raw bits
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float widen(uint32_t bits);
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(uint32_t bits) {
  return __uint_as_float(bits << 16);  // exact: bf16 is fp32's high half
}
template <>
__device__ __forceinline__ float widen<__half>(uint32_t bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}

template <typename T>
__device__ __forceinline__ uint32_t narrow(float v);
template <>
__device__ __forceinline__ uint32_t narrow<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ uint32_t narrow<__half>(float v) {
  return __half_as_ushort(__float2half_rn(v));
}

// v rounded to T and widened back: T's rounding of an fp32 result
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return widen<T>(narrow<T>(v));
  }
}

// A run of VEC consecutive elements: one 16-byte vector, or one element
template <typename T, int VEC>
__device__ __forceinline__ void load_run(const T* p, float (&o)[VEC]) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "a run is 16 bytes");
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) {
      o[0] = *reinterpret_cast<const float*>(p);
    } else {
      o[0] = widen<T>(*reinterpret_cast<const unsigned short*>(p));
    }
  } else if constexpr (sizeof(T) == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  } else {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = widen<T>(w[i] & 0xffffu);
      o[2 * i + 1] = widen<T>(w[i] >> 16);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_run(T* p, const float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float*>(p) = o[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) =
          static_cast<unsigned short>(narrow<T>(o[0]));
    }
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = narrow<T>(o[2 * i]) | (narrow<T>(o[2 * i + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------------------
// The reductions' block sum: each thread's VEC pairs of sums -> one
// partial row per chunk, (chunk, 2, F) fp32
// ---------------------------------------------------------------------------

// red: 2 * kThreads * VEC floats.  Sums over the block's row lanes, in
// lane order, for each of the tile's lanes * VEC features.
template <int VEC>
__device__ __forceinline__ void write_partials(float* red, const float (&s0)[VEC],
                                               const float (&s1)[VEC],
                                               float* __restrict__ partial,
                                               int f) {
  const int lanes = blockDim.x, rlanes = blockDim.y;
  const int width = lanes * VEC;
  const int slot = threadIdx.y * width + threadIdx.x * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[slot + j] = s0[j];
    red[kThreads * VEC + slot + j] = s1[j];
  }
  __syncthreads();
  const int tid = threadIdx.y * lanes + threadIdx.x;
  const int tile_f0 = blockIdx.x * width;
  for (int o = tid; o < 2 * width; o += kThreads) {
    const int k = o / width, e = o - k * width;
    const float* src = red + k * kThreads * VEC + e;
    float s = 0.f;
    for (int i = 0; i < rlanes; ++i) s += src[i * width];
    if (tile_f0 + e < f) {
      partial[(static_cast<size_t>(blockIdx.y) * 2 + k) * f + tile_f0 + e] = s;
    }
  }
}

// The two sums of feature i (< f, block (kFinalLanes, kFinalLanes)) over
// the chunks' partial rows: each chunk lane sums its chunks in order,
// then lane 0 the lanes in order.  Valid in threadIdx.y == 0.
__device__ __forceinline__ void sum_chunks(const float* __restrict__ partial,
                                           int chunks, int f, int i,
                                           float (*red)[kFinalLanes][kFinalLanes + 1],
                                           float (&out)[2]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float s = 0.f;
    if (i < f) {
      for (int c = ty; c < chunks; c += kFinalLanes) {
        s += partial[(static_cast<size_t>(c) * 2 + k) * f + i];
      }
    }
    red[k][ty][tx] = s;
  }
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float s = 0.f;
      for (int q = 0; q < kFinalLanes; ++q) s += red[k][q][tx];
      out[k] = s;
    }
  }
}

struct Finish {
  float* mean_inv;      // (2, F): mean, rsqrt(var + eps)
  float* running_mean;  // (F,)
  float* running_var;   // (F,)
  long long* tracked;   // num_batches_tracked
  float eps, keep, momentum, unbias;  // keep = 1 - momentum
  int update;
};

// Feature i's mean and inv from E[x] and E[x^2], and its running
// statistics moved, in the plain version's order and roundings.
__device__ __forceinline__ void finish_feature(const Finish& p, int f, int i,
                                               float mean, float mean_sq) {
  const float var = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
  p.mean_inv[i] = mean;
  p.mean_inv[f + i] = __frsqrt_rn(__fadd_rn(var, p.eps));
  if (p.update) {
    p.running_mean[i] = __fadd_rn(__fmul_rn(p.keep, p.running_mean[i]),
                                  __fmul_rn(p.momentum, mean));
    p.running_var[i] = __fadd_rn(__fmul_rn(p.keep, p.running_var[i]),
                                 __fmul_rn(p.momentum,
                                           __fmul_rn(var, p.unbias)));
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Per chunk and feature: sum x and sum x^2.  Grid (tiles, chunks).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bnorm_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                       int r, int f, int chunk_rows) {
  __shared__ float red[2 * kThreads * VEC];
  const int rlanes = blockDim.y;
  const int f0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int chunk = blockIdx.y;
  const int r1 = min(r, (chunk + 1) * chunk_rows);
  float s0[VEC], s1[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s0[j] = s1[j] = 0.f;
  if (f0 < f) {
    const T* p = x + f0;
    int row = chunk * chunk_rows + static_cast<int>(threadIdx.y);
    for (; row + (kUnroll - 1) * rlanes < r1; row += kUnroll * rlanes) {
      float v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load_run<T, VEC>(p + static_cast<size_t>(row + u * rlanes) * f, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s0[j] += v[u][j];
          s1[j] += v[u][j] * v[u][j];
        }
      }
    }
    for (; row < r1; row += rlanes) {
      float v[VEC];
      load_run<T, VEC>(p + static_cast<size_t>(row) * f, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s0[j] += v[j];
        s1[j] += v[j] * v[j];
      }
    }
  }
  write_partials<VEC>(red, s0, s1, partial, f);
}

// The chunks summed: E[x] and E[x^2] into stats (2, F), or, with
// p.mean_inv set, straight on to the finish.  Grid ceil(F / 32).
__global__ void __launch_bounds__(kFinalLanes * kFinalLanes)
    bnorm_stats_final_kernel(const float* __restrict__ partial, int chunks,
                             int f, float rows, float* __restrict__ stats,
                             Finish p) {
  __shared__ float red[2][kFinalLanes][kFinalLanes + 1];
  const int i = blockIdx.x * kFinalLanes + threadIdx.x;
  float s[2];
  sum_chunks(partial, chunks, f, i, red, s);
  if (threadIdx.y != 0 || i >= f) return;
  const float mean = __fdiv_rn(s[0], rows);
  const float mean_sq = __fdiv_rn(s[1], rows);
  if (p.mean_inv == nullptr) {
    stats[i] = mean;
    stats[f + i] = mean_sq;
    return;
  }
  finish_feature(p, f, i, mean, mean_sq);
  if (p.update && i == 0) *p.tracked += 1;
}

// The finish from stats (2, F) of E[x] and E[x^2] averaged over a group.
__global__ void __launch_bounds__(256)
    bnorm_finish_kernel(const float* __restrict__ stats, int f, Finish p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= f) return;
  finish_feature(p, f, i, stats[i], stats[f + i]);
  if (p.update && i == 0) *p.tracked += 1;
}

// y from x and the per-feature mean, inv, w, b.  Grid (tiles, chunks).
template <typename T, int VEC, bool LP>
__global__ void __launch_bounds__(kThreads)
    bnorm_normalize_kernel(const T* __restrict__ x,
                           const float* __restrict__ mean_inv,
                           const float* __restrict__ w,
                           const float* __restrict__ b, T* __restrict__ y,
                           int r, int f, int chunk_rows) {
  const int rlanes = blockDim.y;
  const int f0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (f0 >= f) return;
  // LP: (a, c) rounded to T; else (mean, inv, w, b)
  float k0[VEC], k1[VEC], k2[VEC], k3[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = f0 + j;
    const float mean = mean_inv[i], inv = mean_inv[f + i];
    if constexpr (LP) {
      const float a = __fmul_rn(inv, w[i]);
      k0[j] = round_to<T>(a);
      k1[j] = round_to<T>(__fsub_rn(b[i], __fmul_rn(mean, a)));
      k2[j] = k3[j] = 0.f;
    } else {
      k0[j] = mean;
      k1[j] = inv;
      k2[j] = w[i];
      k3[j] = b[i];
    }
  }
  const int chunk = blockIdx.y;
  const int r1 = min(r, (chunk + 1) * chunk_rows);
  int row = chunk * chunk_rows + static_cast<int>(threadIdx.y);
  for (; row < r1; row += kUnroll * rlanes) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row + u * rlanes < r1) {
        load_run<T, VEC>(x + static_cast<size_t>(row + u * rlanes) * f + f0,
                         v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row + u * rlanes >= r1) break;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if constexpr (LP) {
          v[u][j] = __fadd_rn(round_to<T>(__fmul_rn(v[u][j], k0[j])), k1[j]);
        } else {
          v[u][j] = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(v[u][j], k0[j]), k1[j]), k2[j]),
              k3[j]);
        }
      }
      store_run<T, VEC>(y + static_cast<size_t>(row + u * rlanes) * f + f0,
                        v[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Per chunk and feature: sum dy and sum dy * xhat.  Grid (tiles, chunks).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bnorm_grad_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ mean_inv,
                           float* __restrict__ partial, int r, int f,
                           int chunk_rows) {
  __shared__ float red[2 * kThreads * VEC];
  const int rlanes = blockDim.y;
  const int f0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int chunk = blockIdx.y;
  const int r1 = min(r, (chunk + 1) * chunk_rows);
  float s0[VEC], s1[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s0[j] = s1[j] = 0.f;
  if (f0 < f) {
    float mean[VEC], inv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mean[j] = mean_inv[f0 + j];
      inv[j] = mean_inv[f + f0 + j];
    }
    int row = chunk * chunk_rows + static_cast<int>(threadIdx.y);
    for (; row < r1; row += kUnroll * rlanes) {
      float xv[kUnroll][VEC], gv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + u * rlanes < r1) {
          const size_t at = static_cast<size_t>(row + u * rlanes) * f + f0;
          load_run<T, VEC>(x + at, xv[u]);
          load_run<T, VEC>(dy + at, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + u * rlanes >= r1) break;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xhat = __fmul_rn(__fsub_rn(xv[u][j], mean[j]), inv[j]);
          s0[j] += gv[u][j];
          s1[j] += gv[u][j] * xhat;
        }
      }
    }
  }
  write_partials<VEC>(red, s0, s1, partial, f);
}

// The chunks summed: db = sum dy, dw = sum dy * xhat, and their means over
// the rows (2, F) for the dx pass.  Grid ceil(F / 32).
__global__ void __launch_bounds__(kFinalLanes * kFinalLanes)
    bnorm_grad_final_kernel(const float* __restrict__ partial, int chunks,
                            int f, float rows, float* __restrict__ dw,
                            float* __restrict__ db,
                            float* __restrict__ means) {
  __shared__ float red[2][kFinalLanes][kFinalLanes + 1];
  const int i = blockIdx.x * kFinalLanes + threadIdx.x;
  float s[2];
  sum_chunks(partial, chunks, f, i, red, s);
  if (threadIdx.y != 0 || i >= f) return;
  db[i] = s[0];
  dw[i] = s[1];
  means[i] = __fdiv_rn(s[0], rows);
  means[f + i] = __fdiv_rn(s[1], rows);
}

// dx = (w * inv) * ((dy - mean(dy)) - xhat * mean(dy * xhat)).
// Grid (tiles, chunks).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bnorm_grad_input_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const float* __restrict__ mean_inv,
                            const float* __restrict__ w,
                            const float* __restrict__ means,
                            T* __restrict__ dx, int r, int f,
                            int chunk_rows) {
  const int rlanes = blockDim.y;
  const int f0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (f0 >= f) return;
  float mean[VEC], inv[VEC], scale[VEC], g_mean[VEC], gx_mean[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = f0 + j;
    mean[j] = mean_inv[i];
    inv[j] = mean_inv[f + i];
    scale[j] = __fmul_rn(w[i], inv[j]);
    g_mean[j] = means[i];
    gx_mean[j] = means[f + i];
  }
  const int chunk = blockIdx.y;
  const int r1 = min(r, (chunk + 1) * chunk_rows);
  int row = chunk * chunk_rows + static_cast<int>(threadIdx.y);
  for (; row < r1; row += kUnroll * rlanes) {
    float xv[kUnroll][VEC], gv[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row + u * rlanes < r1) {
        const size_t at = static_cast<size_t>(row + u * rlanes) * f + f0;
        load_run<T, VEC>(x + at, xv[u]);
        load_run<T, VEC>(dy + at, gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row + u * rlanes >= r1) break;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = __fmul_rn(__fsub_rn(xv[u][j], mean[j]), inv[j]);
        xv[u][j] = __fmul_rn(
            scale[j], __fsub_rn(__fsub_rn(gv[u][j], g_mean[j]),
                                __fmul_rn(xhat, gx_mean[j])));
      }
      store_run<T, VEC>(dx + static_cast<size_t>(row + u * rlanes) * f + f0,
                        xv[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch plans and type dispatch
// ---------------------------------------------------------------------------

struct Plan {
  int vec, lanes, tiles, chunks, chunk_rows;
  dim3 block() const { return dim3(lanes, kThreads / lanes); }
  dim3 grid() const { return dim3(tiles, chunks); }
};

// The plan covers (r, f) exactly: runs of vec features, lanes runs a
// tile, tiles covering F with no empty tile, chunks of chunk_rows rows
// covering R with no empty chunk.
bool plan_ok(const Plan& p, int r, int f) {
  if (r <= 0 || f <= 0 || p.vec <= 0 || f % p.vec != 0) return false;
  if (p.lanes < 1 || p.lanes > kMaxLanes || (p.lanes & (p.lanes - 1)) != 0) {
    return false;
  }
  const long long tile = static_cast<long long>(p.lanes) * p.vec;
  if (p.tiles < 1 || p.tiles * tile < f || (p.tiles - 1) * tile >= f) {
    return false;
  }
  if (p.chunks < 1 || p.chunks > 65535 || p.chunk_rows < 1 ||
      static_cast<long long>(p.chunks) * p.chunk_rows < r ||
      static_cast<long long>(p.chunks - 1) * p.chunk_rows >= r) {
    return false;
  }
  return true;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int VEC>
struct Tag {
  using type = T;
  static constexpr int vec = VEC;
};

// fn(Tag<T, VEC>{}) for dtype (0 fp32, 1 bf16, 2 fp16) and the plan's run
// width: 1, or one 16-byte vector
template <typename Fn>
cudaError_t dispatch(int dtype, int vec, Fn&& fn) {
  switch (dtype) {
    case 0:
      if (vec == 1) return fn(Tag<float, 1>{});
      if (vec == 4) return fn(Tag<float, 4>{});
      break;
    case 1:
      if (vec == 1) return fn(Tag<__nv_bfloat16, 1>{});
      if (vec == 8) return fn(Tag<__nv_bfloat16, 8>{});
      break;
    case 2:
      if (vec == 1) return fn(Tag<__half, 1>{});
      if (vec == 8) return fn(Tag<__half, 8>{});
      break;
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Forward statistics of x (r, f): partial (plan.chunks x 2 x f fp32
// scratch).  With mean_inv (2, f) the pass finishes: mean and inv, and,
// with update, the running statistics (f,) and num_batches_tracked (one
// int64).  Without it, stats (2, f) gets E[x] and E[x^2] for the caller
// to reduce over its group and finish with batch_norm_train_finish.
extern "C" int batch_norm_train_stats(
    const void* x, void* partial, void* stats, void* mean_inv,
    void* running_mean, void* running_var, void* tracked, int r, int f,
    int vec, int lanes, int tiles, int chunks, int chunk_rows, float eps,
    float keep, float momentum, float unbias, int update, int dtype,
    void* stream) {
  const Plan plan{vec, lanes, tiles, chunks, chunk_rows};
  if (!plan_ok(plan, r, f) || (vec > 1 && !aligned16(x)) ||
      (mean_inv == nullptr && stats == nullptr) ||
      (mean_inv != nullptr && update &&
       (running_mean == nullptr || running_var == nullptr ||
        tracked == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const cudaError_t err = dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(tag)::vec;
    bnorm_stats_kernel<T, VEC><<<plan.grid(), plan.block(), 0, s>>>(
        static_cast<const T*>(x), part, r, f, chunk_rows);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const Finish p{static_cast<float*>(mean_inv),
                 static_cast<float*>(running_mean),
                 static_cast<float*>(running_var),
                 static_cast<long long*>(tracked),
                 eps, keep, momentum, unbias, update};
  bnorm_stats_final_kernel<<<(f + kFinalLanes - 1) / kFinalLanes,
                             dim3(kFinalLanes, kFinalLanes), 0, s>>>(
      part, chunks, f, static_cast<float>(r), static_cast<float*>(stats), p);
  return static_cast<int>(cudaGetLastError());
}

// The finish from stats (2, f) of E[x] and E[x^2] (averaged over a group):
// mean_inv (2, f), and with update the running statistics and the count.
extern "C" int batch_norm_train_finish(const void* stats, void* mean_inv,
                                       void* running_mean, void* running_var,
                                       void* tracked, int f, float eps,
                                       float keep, float momentum,
                                       float unbias, int update,
                                       void* stream) {
  if (f <= 0 || stats == nullptr || mean_inv == nullptr ||
      (update && (running_mean == nullptr || running_var == nullptr ||
                  tracked == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Finish p{static_cast<float*>(mean_inv),
                 static_cast<float*>(running_mean),
                 static_cast<float*>(running_var),
                 static_cast<long long*>(tracked),
                 eps, keep, momentum, unbias, update};
  bnorm_finish_kernel<<<(f + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stats), f, p);
  return static_cast<int>(cudaGetLastError());
}

// y (r, f) in x's type from x, mean_inv (2, f), w and b (f,) fp32; lp (for
// 16-bit x): y = x * a + c in x's type.
extern "C" int batch_norm_train_normalize(const void* x, const void* mean_inv,
                                          const void* w, const void* b,
                                          void* y, int r, int f, int vec,
                                          int lanes, int tiles, int chunks,
                                          int chunk_rows, int lp, int dtype,
                                          void* stream) {
  const Plan plan{vec, lanes, tiles, chunks, chunk_rows};
  if (!plan_ok(plan, r, f) || (vec > 1 && (!aligned16(x) || !aligned16(y)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(tag)::vec;
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    const float* mi = static_cast<const float*>(mean_inv);
    const float* wt = static_cast<const float*>(w);
    const float* bt = static_cast<const float*>(b);
    if (lp && sizeof(T) != 4) {
      bnorm_normalize_kernel<T, VEC, true><<<plan.grid(), plan.block(), 0, s>>>(
          xt, mi, wt, bt, yt, r, f, chunk_rows);
    } else {
      bnorm_normalize_kernel<T, VEC, false>
          <<<plan.grid(), plan.block(), 0, s>>>(xt, mi, wt, bt, yt, r, f,
                                                chunk_rows);
    }
    return cudaGetLastError();
  }));
}

// Backward sums from x and dy (r, f) in one type and mean_inv (2, f):
// dw = sum dy * xhat, db = sum dy (f,), means (2, f) = (db, dw) / r;
// partial as for the statistics.
extern "C" int batch_norm_train_grad_sums(const void* x, const void* dy,
                                          const void* mean_inv, void* partial,
                                          void* dw, void* db, void* means,
                                          int r, int f, int vec, int lanes,
                                          int tiles, int chunks,
                                          int chunk_rows, int dtype,
                                          void* stream) {
  const Plan plan{vec, lanes, tiles, chunks, chunk_rows};
  if (!plan_ok(plan, r, f) || (vec > 1 && (!aligned16(x) || !aligned16(dy)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const cudaError_t err = dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(tag)::vec;
    bnorm_grad_sums_kernel<T, VEC><<<plan.grid(), plan.block(), 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const float*>(mean_inv), part, r, f, chunk_rows);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  bnorm_grad_final_kernel<<<(f + kFinalLanes - 1) / kFinalLanes,
                            dim3(kFinalLanes, kFinalLanes), 0, s>>>(
      part, chunks, f, static_cast<float>(r), static_cast<float*>(dw),
      static_cast<float*>(db), static_cast<float*>(means));
  return static_cast<int>(cudaGetLastError());
}

// dx (r, f) in x's type from x, dy, mean_inv (2, f), w (f,) and means
// (2, f): mean(dy), mean(dy * xhat), over the group where there is one.
extern "C" int batch_norm_train_grad_input(const void* x, const void* dy,
                                           const void* mean_inv,
                                           const void* w, const void* means,
                                           void* dx, int r, int f, int vec,
                                           int lanes, int tiles, int chunks,
                                           int chunk_rows, int dtype,
                                           void* stream) {
  const Plan plan{vec, lanes, tiles, chunks, chunk_rows};
  if (!plan_ok(plan, r, f) ||
      (vec > 1 && (!aligned16(x) || !aligned16(dy) || !aligned16(dx)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(tag)::vec;
    bnorm_grad_input_kernel<T, VEC><<<plan.grid(), plan.block(), 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const float*>(mean_inv), static_cast<const float*>(w),
        static_cast<const float*>(means), static_cast<T*>(dx), r, f,
        chunk_rows);
    return cudaGetLastError();
  }));
}
