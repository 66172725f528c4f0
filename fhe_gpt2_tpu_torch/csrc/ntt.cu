// Negacyclic NTT / inverse NTT over int32 residue rows, one launch per
// transform, for Hopper (sm_90a).
//
// Replaces the TPU kernels fhe_gpt2_tpu/core/tntt.py:_fwd_kernel and
// :_inv_kernel (entries fourstep_ntt / fourstep_intt). It runs the radix-2
// network of core/ntt.py _ntt_stages / _intt_stages with the same [L, N]
// twiddle tables (roots[m + i] = psi^br(m + i)), so the output order equals
// the JAX package's by construction.
//
// Rows are (batch x limb), the table row of row r being r % L. The operand
// may be the limbs [a, a+L) of a contiguous [..., L', N] tensor, read in
// place: x points at limb a of the first row and row m*L + j starts at
// x + (m*L' + j)*N. The output is a contiguous [..., L, N].
//
// What bounds it: memory. Each butterfly is one Shoup product (one
// __umulhi, two multiplies) and two modular adds per 8 bytes of data, far
// below the card's integer rate, so the least time is the row's bytes in
// and out and its twiddles over 3.35 TB/s. The design reads and writes
// each word of the row once: one thread-block cluster of C = 2^LC CTAs per
// row holds the row in the CTAs' shared memory (ntt_cluster.cuh), each
// thread loading and storing its W contiguous words with 16-byte accesses,
// so no stage is a pass over device memory. What remains between it and
// its bound is latency: two cluster barriers, a block barrier per group of
// 2-4 stages and a twiddle-pair load per butterfly block.
//
// N^-1 of the inverse is one Shoup product per word on the way out (every
// modular op returns the canonical residue, so the result is bit-exact
// wherever it is applied).
#include "ntt_cluster.cuh"

namespace {

template <int W, int LC>
__global__ void __launch_bounds__(kClusterThreads, cluster_ctas_per_sm(W))
    ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ roots, const uint32_t* __restrict__ roots_sh,
                   const uint32_t* __restrict__ q, int L, int lp, int logn) {
  extern __shared__ uint32_t sh[];
  const long long n = 1LL << logn;
  const long long row = blockIdx.x >> LC;                // m * L + j
  const int j = (int)(row % L);
  const long long m = row / L;
  // This thread's W contiguous words of the row.
  const long long col0 =
      (long long)cg::this_cluster().block_rank() * (blockDim.x * W) + threadIdx.x * W;
  uint32_t v[W];
  load_words<W>(x + (m * lp + j) * n + col0, v);
  cluster_ntt_fwd<W, LC>(sh, v, logn, roots + j * n, roots_sh + j * n, q[j]);
  store_words<W>(out + row * n + col0, v);
  cg::this_cluster().sync();
}

template <int W, int LC>
__global__ void __launch_bounds__(kClusterThreads, cluster_ctas_per_sm(W))
    ntt_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ iroots, const uint32_t* __restrict__ iroots_sh,
                   const uint32_t* __restrict__ q, const uint32_t* __restrict__ ninv,
                   const uint32_t* __restrict__ ninv_sh, int L, int lp, int logn) {
  extern __shared__ uint32_t sh[];
  const long long n = 1LL << logn;
  const long long row = blockIdx.x >> LC;
  const int j = (int)(row % L);
  const long long m = row / L;
  const long long col0 =
      (long long)cg::this_cluster().block_rank() * (blockDim.x * W) + threadIdx.x * W;
  const uint32_t qj = q[j];
  uint32_t v[W];
  load_words<W>(x + (m * lp + j) * n + col0, v);
  cluster_ntt_inv<W, LC>(sh, v, logn, iroots + j * n, iroots_sh + j * n, qj);
  const uint32_t w = ninv[j], ws = ninv_sh[j];
#pragma unroll
  for (int i = 0; i < W; ++i) v[i] = mul_shoup(v[i], w, ws, qj);
  store_words<W>(out + row * n + col0, v);
}

}  // namespace

extern "C" int ntt_forward(const void* x, void* out, const void* roots, const void* roots_sh,
                           const void* q, long long rows, int L, int lp, int logn, int log_c,
                           int threads, void* stream) {
  return with_cluster_geometry(logn, log_c, threads, [&](auto w, auto lc) {
    constexpr int W = decltype(w)::value, LC = decltype(lc)::value;
    return launch_cluster(ntt_fwd_kernel<W, LC>, rows, LC, threads,
                          sizeof(uint32_t) * W * threads, (cudaStream_t)stream,
                          (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)roots,
                          (const uint32_t*)roots_sh, (const uint32_t*)q, L, lp, logn);
  });
}

extern "C" int ntt_inverse(const void* x, void* out, const void* iroots, const void* iroots_sh,
                           const void* q, const void* ninv, const void* ninv_sh, long long rows,
                           int L, int lp, int logn, int log_c, int threads, void* stream) {
  return with_cluster_geometry(logn, log_c, threads, [&](auto w, auto lc) {
    constexpr int W = decltype(w)::value, LC = decltype(lc)::value;
    return launch_cluster(ntt_inv_kernel<W, LC>, rows, LC, threads,
                          sizeof(uint32_t) * W * threads, (cudaStream_t)stream,
                          (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)iroots,
                          (const uint32_t*)iroots_sh, (const uint32_t*)q,
                          (const uint32_t*)ninv, (const uint32_t*)ninv_sh, L, lp, logn);
  });
}
