// Forward and inverse negacyclic NTT of one limb held across a thread-block
// cluster, and the cluster launch, for Hopper (sm_90a). Used by ntt.cu,
// keyswitch.cu and moddown.cu.
//
// A limb of N = 2^logn words is spread over the C = 2^log_c CTAs of one
// cluster: CTA rank r holds words [r*S, (r+1)*S), S = N / C, in its shared
// memory, and its thread t holds words r*S + t*W .. r*S + t*W + W-1 in
// registers before and after the transform (W = S / threads). The
// transform is the radix-2 network of ntt.cu and of core/ntt.py
// _ntt_stages with the same roots / roots_shoup tables, so the output order
// is the plain version's by construction:
//
//   stages 0 .. log_c-1   butterfly span >= S: the partners of word o of a
//                         CTA are word o of every other CTA. These stages run
//                         as one radix-C pass: each CTA takes S/C of the
//                         columns o, reads the column's C words through
//                         distributed shared memory (DSMEM), runs the log_c
//                         stages in registers and writes them back, between
//                         two cluster.sync() calls;
//   stages log_c .. n-1   span < S, in the CTA's own shared memory, in
//                         groups of up to log2(W) stages: a thread loads the
//                         2^g words of one radix-2^g sub-network, runs its g
//                         stages in registers and stores them back, with one
//                         __syncthreads() per group instead of per stage. The
//                         first group takes the leftover stages; the last
//                         covers spans W/2 .. 1, whose sub-network is the
//                         thread's own W contiguous words, so it ends in the
//                         thread's registers and is never stored.
//
// Shared memory is XOR-swizzled (word i lives at i ^ ((i >> 5) & 31)) so that
// the strided accesses of the last groups spread over the 32 banks.
//
// The inverse (cluster_ntt_inv) runs the Gentleman-Sande network of
// _intt_stages with the inv_roots tables in the mirrored order: spans
// 1 .. W/2 on the thread's own words, the shared-memory groups in rising
// span (the leftover stages last), then the radix-C pass.
//
// Rules the callers keep: every thread of every CTA of a cluster reaches
// every cluster.sync() (no early return, also for a thread that has no
// column in the radix-C pass), and every CTA ends with a cluster.sync()
// after its last DSMEM access, so that no CTA exits while a peer may still
// touch its shared memory (cluster_ntt_inv ends with that one itself).
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <type_traits>
#include "modarith.cuh"

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 512;   // most threads per CTA (__launch_bounds__)

// CTAs of kClusterThreads threads that the cluster kernels keep on one SM
// at W words per thread; it is their __launch_bounds__ minimum, so the
// compiler holds them to 64 registers a thread at W <= 8 (left free, the
// key switch's radix-8 DSMEM pass takes 117 and one CTA per SM). Shared
// memory (4W bytes a thread) never binds first. core/tntt.py ctas_per_sm
// states the same numbers for cluster_for; tests/test_torch_geometry.py
// holds the two equal.
__host__ __device__ constexpr int cluster_ctas_per_sm(int W) { return W <= 8 ? 2 : 1; }

__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 5) & 31); }

template <int W>
__host__ __device__ constexpr int log2_words() {
  return W == 2 ? 1 : W == 4 ? 2 : W == 8 ? 3 : 4;
}

// W consecutive words at p (16-byte aligned when W >= 4) into registers.
template <int W>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p, uint32_t (&x)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int v = 0; v < W / 4; ++v) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + v);
      x[4 * v] = t.x, x[4 * v + 1] = t.y, x[4 * v + 2] = t.z, x[4 * v + 3] = t.w;
    }
  } else {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = t.x, x[1] = t.y;
  }
}

template <int W>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&x)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int v = 0; v < W / 4; ++v)
      reinterpret_cast<uint4*>(p)[v] = make_uint4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(x[0], x[1]);
  }
}

// The g stages of one radix-2^g sub-network in registers: x[m] is word
// g0 + m * 2^a of the limb (g0 its global index at m = 0), the stages those
// with half spans 2^(a+g-1) .. 2^a. Stage span 2^hs is global stage
// logn-1-hs, whose butterfly block of word i takes twiddle
// 2^(logn-1-hs) + (i >> (hs+1)).
template <int G>
__device__ __forceinline__ void radix_fwd(uint32_t (&x)[1 << G], int g0, int a, int logn,
                                          const uint32_t* __restrict__ rt,
                                          const uint32_t* __restrict__ rts, uint32_t q) {
#pragma unroll
  for (int t = G - 1; t >= 0; --t) {
    const int hs = a + t;
    const int tw0 = (1 << (logn - 1 - hs)) + (g0 >> (hs + 1));
#pragma unroll
    for (int blk = 0; blk < (1 << (G - 1 - t)); ++blk) {
      const uint32_t w = __ldg(rt + tw0 + blk), ws = __ldg(rts + tw0 + blk);
#pragma unroll
      for (int b = 0; b < (1 << t); ++b) {
        const int m = (blk << (t + 1)) + b;
        const uint32_t u = x[m];
        const uint32_t v = mul_shoup(x[m + (1 << t)], w, ws, q);
        x[m] = add_mod(u, v, q);
        x[m + (1 << t)] = sub_mod(u, v, q);
      }
    }
  }
}

// The inverse of radix_fwd's stages: the same sub-network and twiddle
// index, Gentleman-Sande butterflies (u, v) -> (u + v, (u - v) * w) in
// rising span 2^a .. 2^(a+G-1), with rt / rts the inv_roots tables.
template <int G>
__device__ __forceinline__ void radix_inv(uint32_t (&x)[1 << G], int g0, int a, int logn,
                                          const uint32_t* __restrict__ rt,
                                          const uint32_t* __restrict__ rts, uint32_t q) {
#pragma unroll
  for (int t = 0; t < G; ++t) {
    const int hs = a + t;
    const int tw0 = (1 << (logn - 1 - hs)) + (g0 >> (hs + 1));
#pragma unroll
    for (int blk = 0; blk < (1 << (G - 1 - t)); ++blk) {
      const uint32_t w = __ldg(rt + tw0 + blk), ws = __ldg(rts + tw0 + blk);
#pragma unroll
      for (int b = 0; b < (1 << t); ++b) {
        const int m = (blk << (t + 1)) + b;
        const uint32_t u = x[m];
        const uint32_t v = x[m + (1 << t)];
        x[m] = add_mod(u, v, q);
        x[m + (1 << t)] = mul_shoup(sub_mod(u, v, q), w, ws, q);
      }
    }
  }
}

// One group of G local stages (spans 2^(a+G-1) .. 2^a) over the CTA's S
// words in shared memory; thread tid runs sub-networks tid + v*T. Inv runs
// radix_inv instead of radix_fwd.
template <int G, int W, bool Inv = false>
__device__ __forceinline__ void smem_group(uint32_t* sh, int a, int rank_s, int logn,
                                           const uint32_t* __restrict__ rt,
                                           const uint32_t* __restrict__ rts, uint32_t q) {
  constexpr int R = 1 << G;
  const int T = blockDim.x;
#pragma unroll
  for (int v = 0; v < W / R; ++v) {
    const int u = threadIdx.x + v * T;
    const int base = (u & ((1 << a) - 1)) + ((u >> a) << (a + G));
    uint32_t x[R];
#pragma unroll
    for (int m = 0; m < R; ++m) x[m] = sh[swz(base + (m << a))];
    if constexpr (Inv)
      radix_inv<G>(x, rank_s + base, a, logn, rt, rts, q);
    else
      radix_fwd<G>(x, rank_s + base, a, logn, rt, rts, q);
#pragma unroll
    for (int m = 0; m < R; ++m) sh[swz(base + (m << a))] = x[m];
  }
  __syncthreads();
}

// x holds this thread's W words of the limb (see the top of the file); on
// return it holds the same words of the limb's NTT. Uses sh (S words). LC is
// log2 of the cluster size.
template <int W, int LC>
__device__ __forceinline__ void cluster_ntt_fwd(uint32_t* sh, uint32_t (&x)[W], int logn,
                                                const uint32_t* __restrict__ rt,
                                                const uint32_t* __restrict__ rts, uint32_t q) {
  constexpr int G = log2_words<W>();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int T = blockDim.x;
  const int S = T * W;
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < W; ++m) sh[swz(tid * W + m)] = x[m];
  cluster.sync();
  const int log_s = logn - LC;
  if constexpr (LC > 0) {
    // Column o holds word r*S + o of every CTA r; CTA rank runs columns
    // [rank*S/C, (rank+1)*S/C) through the radix-C network in registers.
    const int cols = S >> LC;
    for (int o = rank * cols + tid; o < (rank + 1) * cols; o += T) {
      uint32_t v[1 << LC];
      const int so = swz(o);
#pragma unroll
      for (int r = 0; r < (1 << LC); ++r) v[r] = cluster.map_shared_rank(sh, r)[so];
      radix_fwd<LC>(v, o, log_s, logn, rt, rts, q);
#pragma unroll
      for (int r = 0; r < (1 << LC); ++r) cluster.map_shared_rank(sh, r)[so] = v[r];
    }
    cluster.sync();
  }
  const int rank_s = rank * S;
  int a = log_s;                              // spans 2^(a-1) .. 1 remain
  if constexpr (G > 1) {
    switch (a % G) {
      case 1: smem_group<1, W>(sh, a -= 1, rank_s, logn, rt, rts, q); break;
      case 2: if constexpr (G > 2) smem_group<2, W>(sh, a -= 2, rank_s, logn, rt, rts, q); break;
      case 3: if constexpr (G > 3) smem_group<3, W>(sh, a -= 3, rank_s, logn, rt, rts, q); break;
    }
  }
  while (a > G) smem_group<G, W>(sh, a -= G, rank_s, logn, rt, rts, q);
#pragma unroll
  for (int m = 0; m < W; ++m) x[m] = sh[swz(tid * W + m)];
  radix_fwd<G>(x, rank_s + tid * W, 0, logn, rt, rts, q);
}

// x holds this thread's W words of the limb; on return it holds the same
// words of the limb's inverse NTT before the N^-1 scaling, which the caller
// applies. Uses sh (S words); ends with a cluster.sync() after its DSMEM
// pass. LC is log2 of the cluster size; rt / rts are the inv_roots tables.
template <int W, int LC>
__device__ __forceinline__ void cluster_ntt_inv(uint32_t* sh, uint32_t (&x)[W], int logn,
                                                const uint32_t* __restrict__ rt,
                                                const uint32_t* __restrict__ rts, uint32_t q) {
  constexpr int G = log2_words<W>();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int T = blockDim.x;
  const int S = T * W;
  const int tid = threadIdx.x;
  const int rank_s = rank * S;
  const int log_s = logn - LC;
  radix_inv<G>(x, rank_s + tid * W, 0, logn, rt, rts, q);
#pragma unroll
  for (int m = 0; m < W; ++m) sh[swz(tid * W + m)] = x[m];
  __syncthreads();
  int a = G;                                  // spans 2^a .. 2^(log_s-1) remain
  for (; a + G <= log_s; a += G) smem_group<G, W, true>(sh, a, rank_s, logn, rt, rts, q);
  if constexpr (G > 1) {
    switch (log_s - a) {
      case 1: smem_group<1, W, true>(sh, a, rank_s, logn, rt, rts, q); break;
      case 2: if constexpr (G > 2) smem_group<2, W, true>(sh, a, rank_s, logn, rt, rts, q); break;
      case 3: if constexpr (G > 3) smem_group<3, W, true>(sh, a, rank_s, logn, rt, rts, q); break;
    }
  }
  if constexpr (LC > 0) {
    // Column o holds word r*S + o of every CTA r (see cluster_ntt_fwd).
    cluster.sync();
    const int cols = S >> LC;
    for (int o = rank * cols + tid; o < (rank + 1) * cols; o += T) {
      uint32_t v[1 << LC];
      const int so = swz(o);
#pragma unroll
      for (int r = 0; r < (1 << LC); ++r) v[r] = cluster.map_shared_rank(sh, r)[so];
      radix_inv<LC>(v, o, log_s, logn, rt, rts, q);
#pragma unroll
      for (int r = 0; r < (1 << LC); ++r) cluster.map_shared_rank(sh, r)[so] = v[r];
    }
    cluster.sync();
  }
#pragma unroll
  for (int m = 0; m < W; ++m) x[m] = sh[swz(tid * W + m)];
}

// Launches kernel on clusters * 2^log_c CTAs of `threads` threads in
// clusters of 2^log_c, with `smem` bytes of dynamic shared memory; returns
// the first CUDA error (0 when the launch was accepted).
template <typename... Params, typename... Args>
inline int launch_cluster(void (*kernel)(Params...), long long clusters, int log_c, int threads,
                          size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters << log_c), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Returns f(W, LC) with W the words per thread of a CTA holding
// S = 2^(logn - log_c) words with `threads` threads and LC = log_c, both as
// std::integral_constant: the kernels are instantiated for W in
// {2, 4, 8, 16} and LC in {0, 1, 2, 3} only. Any other geometry returns
// cudaErrorInvalidValue and launches nothing.
template <typename F>
inline int with_cluster_geometry(int logn, int log_c, int threads, F f) {
  constexpr int kBad = (int)cudaErrorInvalidValue;
  if (threads <= 0 || threads > kClusterThreads || log_c < 0 || log_c > 3 || log_c >= logn)
    return kBad;
  const int S = 1 << (logn - log_c);
  if (S % threads != 0) return kBad;
  auto by_lc = [&](auto w) -> int {
    switch (log_c) {
      case 0: return f(w, std::integral_constant<int, 0>{});
      case 1: return f(w, std::integral_constant<int, 1>{});
      case 2: return f(w, std::integral_constant<int, 2>{});
      case 3: return f(w, std::integral_constant<int, 3>{});
    }
    return kBad;
  };
  switch (S / threads) {
    case 2: return by_lc(std::integral_constant<int, 2>{});
    case 4: return by_lc(std::integral_constant<int, 4>{});
    case 8: return by_lc(std::integral_constant<int, 8>{});
    case 16: return by_lc(std::integral_constant<int, 16>{});
  }
  return kBad;
}
