// 2s-AGCN's per-sample adaptive adjacency: the attention C_k(x) of a
// unit's K subsets, its softmax and the graph it joins, and the backward.
//
// Replaces no Pallas kernel: the reference package's ``stgcn`` family
// computes its attention with jnp einsums that XLA fuses; the port's
// ``agcn2s`` family (models/agcn.py) is the published 2s-AGCN (Shi et
// al., CVPR 2019), whose every unit builds, per sample and per subset,
//
//     S_k[n,v,u] = sum_{t<T, c<d} a_k[n,v,t,c] b_k[n,u,t,c] / (d*T),
//     P_k[n,:,u] = softmax over v of S_k[n,:,u],
//     G_k[n]     = P_k[n] + (A_k + PA_k).
//
// Layout.  The model holds a unit's input as (N', V, T, C) and computes
// the embeddings of all K subsets as one tensor E (N', V, T, 2*K*d): for
// each node (n, v, t) the K a_k of d channels each, then the K b_k.  The
// softmax state P and the graph G are (N', K, V, V), G[n,k,v,u] the
// weight of source joint v in target joint u (the published x @ A).
//
// What bounds it.  E is read once forward and once backward, and dE is
// written once: 4.4 GB a step at the published widths, ~1.3 ms forward
// and ~2.6 ms backward at 3.35 TB/s.  The contraction is 2*N'*K*d*T*V^2
// FLOPs, a quarter of the bytes' time at the fp32 SIMT rate, so the
// kernels are memory-bound, and their design keeps the arithmetic in
// registers: each block streams a chunk of frames of one sample through
// shared memory, once, for all K subsets at a time.
//
// Forward (one launch counted; two passes):
//   partial  block (chunk, n): for each stage of frames, the stage's a and
//            b (all K) into shared memory as [k][frame, channel][v], v
//            padded to VP (a multiple of 4); each thread holds a 4 x 4
//            tile of one subset's (v, u) sums in registers over the
//            chunk's frames (agcn_adjacency_partial_kernel), and writes
//            them to partial[n][chunk][k][v][u];
//   final    thread (n, k, u): the chunks summed in order, divided by
//            d*T, the softmax over v, P and G = P + (A + PA) written
//            (agcn_adjacency_final_kernel).
// Backward (one launch counted; one pass):
//   block (chunk, n): dS = P (dG - sum_v P dG) / (d*T) of every subset
//   into shared memory, twice (v-major and u-major), then for each stage
//   of frames, the stage's embeddings in their own layout; a thread
//   computes 4 joints x 4 channels of da = dS b^T and of db = dS^T a at
//   a time (agcn_adjacency_backward_kernel).  dPA = sum_n dG is the
//   caller's (a stock reduction).
//
// Sums run in a fixed order that depends on the shapes alone (the chunks
// are fixed by ops/adaptive.py), so a run is repeatable bit for bit.
// Limits: V <= 64 and K <= 4 (a forward block holds K*(VP/4)^2 <= 1024
// threads), d a multiple of 4 (every load and store moves four channels;
// the published d = C_out/4 is 16, 32 or 64), and each kernel's shared
// memory within the card's 227 KB; the wrapper refuses other shapes
// before launching.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxV = 64;
constexpr int kBackwardThreads = 256;
constexpr int kFinalThreads = 64;

// Stage frames [ts, ts + nf) of sample n's embeddings into shared memory
// as s[((ab * K + k) * J + f * D + c) * VP + v], four channels a load; a
// lane per joint, so that the transposed stores hit distinct banks.
__device__ __forceinline__ void stage_transposed(
    const float* __restrict__ en, float* s, int V, int T, int K, int D,
    int J, int VP, int ts, int nf) {
  const int q = 2 * K * D;
  const int d4 = D / 4;
  const int total = nf * 2 * K * d4 * V;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int v = i % V;
    int rest = i / V;
    const int c4 = rest % d4;
    rest /= d4;
    const int abk = rest % (2 * K);
    const int f = rest / (2 * K);
    const float4 x = __ldg(reinterpret_cast<const float4*>(
        en + ((size_t)v * T + ts + f) * q + abk * D + c4 * 4));
    float* dst = s + ((size_t)abk * J + f * D + c4 * 4) * VP + v;
    dst[0] = x.x;
    dst[VP] = x.y;
    dst[2 * VP] = x.z;
    dst[3 * VP] = x.w;
  }
}

__global__ void agcn_adjacency_partial_kernel(
    const float* __restrict__ e, float* __restrict__ partial, int V, int T,
    int K, int D, int VP, int FS, int FC, int chunks) {
  extern __shared__ float smem[];
  const int J = FS * D;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int q = 2 * K * D;
  const int t0 = chunk * FC, t1 = min(T, t0 + FC);
  const float* en = e + (size_t)n * V * T * q;
  const int tv = VP / 4;
  const int tid = threadIdx.x;
  const bool computes = tid < K * tv * tv;
  const int k = tid / (tv * tv), r = tid % (tv * tv);
  const int v0 = (r / tv) * 4, u0 = (r % tv) * 4;
  // the padded joints read as zeros
  for (int i = tid; i < 2 * K * J * VP; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[i][l] = 0.f;
  const float* pa = smem + (size_t)k * J * VP + v0;
  const float* pb = smem + ((size_t)(K + k) * J) * VP + u0;
  for (int ts = t0; ts < t1; ts += FS) {
    const int nf = min(FS, t1 - ts);
    stage_transposed(en, smem, V, T, K, D, J, VP, ts, nf);
    __syncthreads();
    if (computes) {
      const int jn = nf * D;
      for (int j = 0; j < jn; ++j) {
        const float4 a4 = *reinterpret_cast<const float4*>(pa + j * VP);
        const float4 b4 = *reinterpret_cast<const float4*>(pb + j * VP);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[i][l] = fmaf(av[i], bv[l], acc[i][l]);
      }
    }
    __syncthreads();
  }
  if (!computes) return;
  float* out = partial + (((size_t)n * chunks + chunk) * K + k) * V * V;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (v0 + i >= V) break;
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if (u0 + l < V) out[(v0 + i) * V + u0 + l] = acc[i][l];
  }
}

__global__ void agcn_adjacency_final_kernel(
    const float* __restrict__ partial, const float* __restrict__ a,
    const float* __restrict__ pa, float* __restrict__ p,
    float* __restrict__ g, int V, int K, int chunks, float denom) {
  const int nk = blockIdx.x;
  const int n = nk / K, k = nk % K;
  const int u = threadIdx.x;
  if (u >= V) return;
  const size_t vv = (size_t)V * V;
  float s[kMaxV];
  float top = -INFINITY;
  for (int v = 0; v < V; ++v) {
    float sum = 0.f;
    for (int ch = 0; ch < chunks; ++ch)
      sum += partial[(((size_t)n * chunks + ch) * K + k) * vv + v * V + u];
    s[v] = sum / denom;
    top = fmaxf(top, s[v]);
  }
  float total = 0.f;
  for (int v = 0; v < V; ++v) {
    s[v] = expf(s[v] - top);
    total += s[v];
  }
  const size_t base = ((size_t)n * K + k) * vv;
  for (int v = 0; v < V; ++v) {
    const float prob = s[v] / total;
    const size_t at = (size_t)k * vv + v * V + u;
    p[base + v * V + u] = prob;
    g[base + v * V + u] = prob + (a[at] + pa[at]);
  }
}

__global__ void agcn_adjacency_backward_kernel(
    const float* __restrict__ e, const float* __restrict__ p,
    const float* __restrict__ dg, float* __restrict__ de, int V, int T,
    int K, int D, int VP, int FS, int FC, float denom) {
  extern __shared__ float smem[];
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int q = 2 * K * D;
  const int t0 = chunk * FC, t1 = min(T, t0 + FC);
  const size_t vv = (size_t)V * V;
  float* ds_u = smem;                          // [k][u][v (VP)]
  float* ds_v = smem + (size_t)K * V * VP;     // [k][v][u (VP)]
  float* stage = ds_v + (size_t)K * V * VP;    // [v][f][q]
  const int run = FS * q;                      // a joint's floats a stage
  const float* pn = p + (size_t)n * K * vv;
  const float* gn = dg + (size_t)n * K * vv;
  for (int i = threadIdx.x; i < 2 * K * V * VP; i += blockDim.x)
    smem[i] = 0.f;
  __syncthreads();
  for (int ku = threadIdx.x; ku < K * V; ku += blockDim.x) {
    const int k = ku / V, u = ku % V;
    const float* pc = pn + k * vv + u;
    const float* gc = gn + k * vv + u;
    float dot = 0.f;
    for (int v = 0; v < V; ++v) dot = fmaf(pc[v * V], gc[v * V], dot);
    for (int v = 0; v < V; ++v) {
      const float ds = pc[v * V] * (gc[v * V] - dot) / denom;
      ds_u[((size_t)k * V + u) * VP + v] = ds;
      ds_v[((size_t)k * V + v) * VP + u] = ds;
    }
  }
  const int tv = VP / 4, dc = D / 4;
  const float* en = e + (size_t)n * V * T * q;
  float* dn = de + (size_t)n * V * T * q;
  for (int ts = t0; ts < t1; ts += FS) {
    const int nf = min(FS, t1 - ts);
    const int per_v = nf * q / 4;
    __syncthreads();
    for (int i = threadIdx.x; i < V * per_v; i += blockDim.x) {
      const int v = i / per_v, w = (i % per_v) * 4;
      *reinterpret_cast<float4*>(stage + (size_t)v * run + w) =
          __ldg(reinterpret_cast<const float4*>(
              en + ((size_t)v * T + ts) * q + w));
    }
    __syncthreads();
    // tiles (side, f, k, joint tile, channel tile), channels fastest
    const int tiles = nf * K * tv * dc;
    for (int i = threadIdx.x; i < 2 * tiles; i += blockDim.x) {
      const int side = i / tiles;   // 0: da (rows v), 1: db (rows u)
      int rest = i % tiles;
      const int c0 = (rest % dc) * 4;
      rest /= dc;
      const int j0 = (rest % tv) * 4;
      rest /= tv;
      const int k = rest % K, f = rest / K;
      // da[v] = sum_u dS[v,u] b[u]; db[u] = sum_v dS[v,u] a[v]
      const float* ds = (side == 0 ? ds_u : ds_v) + (size_t)k * V * VP + j0;
      const float* src = stage + (size_t)f * q + (1 - side) * K * D + k * D
                         + c0;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[r][l] = 0.f;
      for (int o = 0; o < V; ++o) {
        const float4 s4 = *reinterpret_cast<const float4*>(ds + o * VP);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        const float4 x4 =
            *reinterpret_cast<const float4*>(src + (size_t)o * run);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[r][l] = fmaf(sv[r], xv[l], acc[r][l]);
      }
      float* out = dn + (size_t)(ts + f) * q + side * K * D + k * D + c0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (j0 + r >= V) break;
        *reinterpret_cast<float4*>(out + (size_t)(j0 + r) * T * q) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// e (n, v, t, 2*k*d) -> p, g (n, k, v, v); partial: n*chunks*k*v*v
// floats of scratch.  fs frames a stage, fc frames a chunk (a multiple
// of fs), vp = v rounded up to 4; d a multiple of 4 and e 16-byte
// aligned (ops/adaptive.py sees to both).
int agcn_adjacency_forward(const float* e, const float* a, const float* pa,
                           float* partial, float* p, float* g, int n, int v,
                           int t, int k, int d, int vp, int fs, int fc,
                           int chunks, cudaStream_t stream) {
  const dim3 grid(chunks, n);
  const int tv = vp / 4;
  const int threads = (k * tv * tv + 31) / 32 * 32;
  const size_t smem = sizeof(float) * 2 * k * fs * d * vp;
  int status = set_smem((const void*)agcn_adjacency_partial_kernel, smem);
  if (status) return status;
  agcn_adjacency_partial_kernel<<<grid, threads, smem, stream>>>(
      e, partial, v, t, k, d, vp, fs, fc, chunks);
  status = (int)cudaGetLastError();
  if (status) return status;
  agcn_adjacency_final_kernel<<<n * k, kFinalThreads, 0, stream>>>(
      partial, a, pa, p, g, v, k, chunks, (float)d * (float)t);
  return (int)cudaGetLastError();
}

// (e, p, dg) -> de, the layout of e; d a multiple of 4, e and de 16-byte
// aligned.
int agcn_adjacency_backward(const float* e, const float* p, const float* dg,
                            float* de, int n, int v, int t, int k, int d,
                            int vp, int fs, int fc, int chunks,
                            cudaStream_t stream) {
  const dim3 grid(chunks, n);
  const size_t smem =
      sizeof(float) * ((size_t)2 * k * v * vp + (size_t)v * fs * 2 * k * d);
  int status = set_smem((const void*)agcn_adjacency_backward_kernel, smem);
  if (status) return status;
  agcn_adjacency_backward_kernel<<<grid, kBackwardThreads, smem, stream>>>(
      e, p, dg, de, v, t, k, d, vp, fs, fc, (float)d * (float)t);
  return (int)cudaGetLastError();
}

}  // extern "C"
