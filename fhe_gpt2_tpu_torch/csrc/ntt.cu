// Negacyclic NTT / inverse NTT over int32 residue rows, for Hopper (sm_90a).
//
// Replaces the TPU kernels fhe_gpt2_tpu/core/tntt.py:_fwd_kernel and
// :_inv_kernel (entries fourstep_ntt / fourstep_intt). It runs the radix-2
// network of core/ntt.py _ntt_stages / _intt_stages with the same [L, N]
// twiddle tables (roots[m + i] = psi^br(m + i)), so the output order equals
// the JAX package's by construction.
//
// What bounds it: memory. Each butterfly is one Shoup product (one
// __umulhi, two multiplies) and two modular adds per 8 bytes of data, far
// below the card's integer rate, so the least time is the bytes of the row
// and its twiddles over 3.35 TB/s. The design keeps a segment of each row
// in shared memory and runs every stage that stays inside the segment
// there, so those stages cost one read and one write of the data. A segment
// holds S = 2^seg_log words (at most 2^15 = 128 KB of the 227 KB a block
// can use); stages whose butterfly span is wider than a segment (stage 0 of
// N = 65536, or the first stages when the caller picks smaller segments to
// put more blocks on the 132 SMs) run first as global-memory passes, one
// launch per stage. After those, each segment is an independent
// sub-network. The inverse runs the same in reverse order and multiplies
// by N^-1 in its last stage.
//
// Rows are (batch x limb) flattened; the table row of row r is r % L.
#include <cuda_runtime.h>
#include "modarith.cuh"

namespace {

// One forward stage s over global memory: dst may equal src.
__global__ void fwd_global_stage(const uint32_t* src, uint32_t* dst,
                                 const uint32_t* __restrict__ roots,
                                 const uint32_t* __restrict__ roots_sh,
                                 const uint32_t* __restrict__ qs, long long pairs,
                                 int L, int logn, int s) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int n = 1 << logn;
  const int hs = logn - s - 1;                 // log2(half)
  long long row = p >> (logn - 1);
  int k = (int)(p & ((n >> 1) - 1));
  int limb = (int)(row % L);
  int i = k >> hs;
  int idx = (i << (hs + 1)) + (k & ((1 << hs) - 1));
  long long off = row * n;
  long long t = (long long)limb * n + (1 << s) + i;
  uint32_t q = qs[limb];
  uint32_t u = src[off + idx];
  uint32_t v = mul_shoup(src[off + idx + (1 << hs)], roots[t], roots_sh[t], q);
  dst[off + idx] = add_mod(u, v, q);
  dst[off + idx + (1 << hs)] = sub_mod(u, v, q);
}

// One inverse stage s over global memory; the last stage (s == 0) also
// multiplies by N^-1.
__global__ void inv_global_stage(const uint32_t* src, uint32_t* dst,
                                 const uint32_t* __restrict__ iroots,
                                 const uint32_t* __restrict__ iroots_sh,
                                 const uint32_t* __restrict__ qs,
                                 const uint32_t* __restrict__ ninv,
                                 const uint32_t* __restrict__ ninv_sh, long long pairs,
                                 int L, int logn, int s) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int n = 1 << logn;
  const int hs = logn - s - 1;
  long long row = p >> (logn - 1);
  int k = (int)(p & ((n >> 1) - 1));
  int limb = (int)(row % L);
  int i = k >> hs;
  int idx = (i << (hs + 1)) + (k & ((1 << hs) - 1));
  long long off = row * n;
  long long t = (long long)limb * n + (1 << s) + i;
  uint32_t q = qs[limb];
  uint32_t u = src[off + idx];
  uint32_t v = src[off + idx + (1 << hs)];
  uint32_t a = add_mod(u, v, q);
  uint32_t b = mul_shoup(sub_mod(u, v, q), iroots[t], iroots_sh[t], q);
  if (s == 0) {
    a = mul_shoup(a, ninv[limb], ninv_sh[limb], q);
    b = mul_shoup(b, ninv[limb], ninv_sh[limb], q);
  }
  dst[off + idx] = a;
  dst[off + idx + (1 << hs)] = b;
}

// Stages g .. logn-1 of one segment (g = logn - seg_log) in shared memory.
// Block b handles segment (b mod 2^g) of row (b >> g).
__global__ void fwd_smem(const uint32_t* src, uint32_t* dst,
                         const uint32_t* __restrict__ roots,
                         const uint32_t* __restrict__ roots_sh,
                         const uint32_t* __restrict__ qs, int L, int logn, int seg_log) {
  extern __shared__ uint32_t sh[];
  const int n = 1 << logn;
  const int S = 1 << seg_log;
  const int g = logn - seg_log;
  long long row = (long long)blockIdx.x >> g;
  int seg = (int)(blockIdx.x & ((1u << g) - 1));
  int limb = (int)(row % L);
  long long off = row * n + (long long)seg * S;
  for (int t = threadIdx.x; t < S; t += blockDim.x) sh[t] = src[off + t];
  __syncthreads();
  const uint32_t q = qs[limb];
  const uint32_t* rt = roots + (long long)limb * n;
  const uint32_t* rts = roots_sh + (long long)limb * n;
  for (int s = g; s < logn; ++s) {
    const int hs = logn - s - 1;
    const int half = 1 << hs;
    // Global butterfly block index of local block i: seg * 2^(s-g) + i.
    const int tb = (1 << s) + (seg << (s - g));
    for (int k = threadIdx.x; k < (S >> 1); k += blockDim.x) {
      int i = k >> hs;
      int idx = (i << (hs + 1)) + (k & (half - 1));
      uint32_t u = sh[idx];
      uint32_t v = mul_shoup(sh[idx + half], rt[tb + i], rts[tb + i], q);
      sh[idx] = add_mod(u, v, q);
      sh[idx + half] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < S; t += blockDim.x) dst[off + t] = sh[t];
}

// Inverse stages logn-1 .. g of one segment; with g == 0 the N^-1 multiply
// is folded into the store.
__global__ void inv_smem(const uint32_t* src, uint32_t* dst,
                         const uint32_t* __restrict__ iroots,
                         const uint32_t* __restrict__ iroots_sh,
                         const uint32_t* __restrict__ qs,
                         const uint32_t* __restrict__ ninv,
                         const uint32_t* __restrict__ ninv_sh, int L, int logn,
                         int seg_log) {
  extern __shared__ uint32_t sh[];
  const int n = 1 << logn;
  const int S = 1 << seg_log;
  const int g = logn - seg_log;
  long long row = (long long)blockIdx.x >> g;
  int seg = (int)(blockIdx.x & ((1u << g) - 1));
  int limb = (int)(row % L);
  long long off = row * n + (long long)seg * S;
  for (int t = threadIdx.x; t < S; t += blockDim.x) sh[t] = src[off + t];
  __syncthreads();
  const uint32_t q = qs[limb];
  const uint32_t* rt = iroots + (long long)limb * n;
  const uint32_t* rts = iroots_sh + (long long)limb * n;
  for (int s = logn - 1; s >= g; --s) {
    const int hs = logn - s - 1;
    const int half = 1 << hs;
    const int tb = (1 << s) + (seg << (s - g));
    for (int k = threadIdx.x; k < (S >> 1); k += blockDim.x) {
      int i = k >> hs;
      int idx = (i << (hs + 1)) + (k & (half - 1));
      uint32_t u = sh[idx];
      uint32_t v = sh[idx + half];
      sh[idx] = add_mod(u, v, q);
      sh[idx + half] = mul_shoup(sub_mod(u, v, q), rt[tb + i], rts[tb + i], q);
    }
    __syncthreads();
  }
  if (g == 0) {
    const uint32_t w = ninv[limb], ws = ninv_sh[limb];
    for (int t = threadIdx.x; t < S; t += blockDim.x)
      dst[off + t] = mul_shoup(sh[t], w, ws, q);
  } else {
    for (int t = threadIdx.x; t < S; t += blockDim.x) dst[off + t] = sh[t];
  }
}

constexpr int kGlobalThreads = 256;

int smem_threads(int seg_log) { return (1 << (seg_log - 1)) < 1024 ? (1 << (seg_log - 1)) : 1024; }

}  // namespace

extern "C" int ntt_forward(const void* x, void* out, const void* roots, const void* roots_sh,
                           const void* q, long long rows, int L, int logn, int seg_log,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int g = logn - seg_log;
  const long long pairs = rows << (logn - 1);
  const uint32_t* src = (const uint32_t*)x;
  uint32_t* dst = (uint32_t*)out;
  const uint32_t* rt = (const uint32_t*)roots;
  const uint32_t* rts = (const uint32_t*)roots_sh;
  const uint32_t* qs = (const uint32_t*)q;
  for (int s = 0; s < g; ++s) {
    unsigned blocks = (unsigned)((pairs + kGlobalThreads - 1) / kGlobalThreads);
    fwd_global_stage<<<blocks, kGlobalThreads, 0, st>>>(src, dst, rt, rts, qs, pairs, L,
                                                        logn, s);
    src = dst;
  }
  size_t smem = sizeof(uint32_t) << seg_log;
  cudaError_t e = cudaFuncSetAttribute(fwd_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  fwd_smem<<<(unsigned)(rows << g), smem_threads(seg_log), smem, st>>>(src, dst, rt, rts, qs,
                                                                       L, logn, seg_log);
  return (int)cudaGetLastError();
}

extern "C" int ntt_inverse(const void* x, void* out, const void* iroots,
                           const void* iroots_sh, const void* q, const void* ninv,
                           const void* ninv_sh, long long rows, int L, int logn,
                           int seg_log, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int g = logn - seg_log;
  const long long pairs = rows << (logn - 1);
  const uint32_t* rt = (const uint32_t*)iroots;
  const uint32_t* rts = (const uint32_t*)iroots_sh;
  const uint32_t* qs = (const uint32_t*)q;
  const uint32_t* ni = (const uint32_t*)ninv;
  const uint32_t* nis = (const uint32_t*)ninv_sh;
  uint32_t* dst = (uint32_t*)out;
  size_t smem = sizeof(uint32_t) << seg_log;
  cudaError_t e = cudaFuncSetAttribute(inv_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  inv_smem<<<(unsigned)(rows << g), smem_threads(seg_log), smem, st>>>(
      (const uint32_t*)x, dst, rt, rts, qs, ni, nis, L, logn, seg_log);
  for (int s = g - 1; s >= 0; --s) {
    unsigned blocks = (unsigned)((pairs + kGlobalThreads - 1) / kGlobalThreads);
    inv_global_stage<<<blocks, kGlobalThreads, 0, st>>>(dst, dst, rt, rts, qs, ni, nis,
                                                        pairs, L, logn, s);
  }
  return (int)cudaGetLastError();
}
