// Hybrid key switch in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel fhe_gpt2_tpu/core/tks.py:_ks_kernel (entry
// fused_switch_key), which in one Pallas program per key limb j keeps the
// limb in VMEM while it accumulates the base-conversion MAC, runs the
// forward NTT, splices the digit's own limbs and multiplies by the key.
// Here one thread-block cluster per (batch m, key limb j) does the same
// with the limb in the cluster's shared memory (ntt_cluster.cuh). For each
// digit d = 0..D-1:
//
//   own[d, j] set (data limb j of digit d):  poly = c_ntt[m, j]  (no NTT)
//   otherwise:  t = sum_a ((c_coeff[m, gather[d, a]] * inv_punc[d, a])
//                          mod src_q[d, a]) * pw[d, j, a]   mod q_j
//               poly = NTT_j(t), t held across the cluster
//   acc_c += poly * key[c, d, j] * 2^-32   mod q_j,  c = 0, 1  (registers)
//
// and out[c, m, j] = acc_c * 2^32 mod q_j is written once after the last
// digit. c_coeff is the iNTT of c_ntt (ntt.cu, run by the wrapper before
// this launch).
//
// What bounds it: the bytes are c (read as c_ntt and c_coeff), the key and
// the output, each once from device memory (the re-reads of c_coeff by the
// J clusters hit L2); the t intermediate of the three-launch design no
// longer exists. The arithmetic is 2A Shoup products per word of t (both
// factors inv_punc and pw are table words), 15-16 Shoup butterflies per
// NTT, and 2D Montgomery products per output word for the key (a data
// operand, so no Shoup word exists; Montgomery takes three multiplies where
// a 64-bit Barrett reduction takes about eight). The design keeps t in
// shared memory and the two accumulators and the words of the digit in
// registers (W words per thread).
//
// c_ntt is read only where digit d owns limb j, which holds only for data
// limbs (j < l): the special limbs never read past c_ntt's l rows.
#include "ntt_cluster.cuh"

namespace {

template <int W, int LC>
__global__ void __launch_bounds__(kClusterThreads, cluster_ctas_per_sm(W))
    ks_fused_kernel(const uint32_t* __restrict__ ccoef, const uint32_t* __restrict__ cntt,
                    const uint32_t* __restrict__ key, const int* __restrict__ own,
                    const uint32_t* __restrict__ pw, const uint32_t* __restrict__ pws,
                    const int* __restrict__ gather, const uint32_t* __restrict__ ip,
                    const uint32_t* __restrict__ ips, const uint32_t* __restrict__ srcq,
                    const uint32_t* __restrict__ q, const uint32_t* __restrict__ mont,
                    const uint32_t* __restrict__ roots, const uint32_t* __restrict__ roots_sh,
                    uint32_t* __restrict__ out, int M, int D, int A, int J, int l, int logn) {
  extern __shared__ uint32_t sh[];
  const int n = 1 << logn;
  // Cluster m * J + j, last first: the special limbs (j >= l), which own no
  // digit and so run D NTTs instead of D - 1, start before the data limbs.
  const long long cid = (long long)M * J - 1 - (blockIdx.x >> LC);
  const int j = (int)(cid % J);
  const long long m = cid / J;
  // This thread's W contiguous words of the limb.
  const long long col0 =
      (long long)cg::this_cluster().block_rank() * (blockDim.x * W) + threadIdx.x * W;
  const uint32_t qj = q[j], qneg = mont[j], r32 = mont[J + j], r32s = mont[2 * J + j];
  const long long key_c = (long long)D * J * n;   // stride between key components
  const uint32_t* cbase = ccoef + m * l * (long long)n + col0;
  uint32_t acc0[W], acc1[W], poly[W], y[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc0[w] = acc1[w] = 0;
  for (int d = 0; d < D; ++d) {
    const uint32_t* kp = key + ((long long)d * J + j) * n + col0;
    if (own[d * J + j]) {
      load_words<W>(cntt + (m * l + j) * n + col0, poly);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) poly[w] = 0;
      for (int a = 0; a < A; ++a) {
        const uint32_t sq = srcq[d * A + a];
        if (sq == 1) break;                      // padding of a narrow digit
        const uint32_t iv = ip[d * A + a], ivs = ips[d * A + a];
        const long long pa = ((long long)d * J + j) * A + a;
        const uint32_t pwa = pw[pa], pwas = pws[pa];
        load_words<W>(cbase + (long long)gather[d * A + a] * n, y);
#pragma unroll
        for (int w = 0; w < W; ++w)
          poly[w] = add_mod(poly[w], mul_shoup(mul_shoup(y[w], iv, ivs, sq), pwa, pwas, qj), qj);
      }
      cluster_ntt_fwd<W, LC>(sh, poly, logn, roots + (long long)j * n,
                             roots_sh + (long long)j * n, qj);
    }
    load_words<W>(kp, y);
#pragma unroll
    for (int w = 0; w < W; ++w) acc0[w] = add_mod(acc0[w], mont_mul(poly[w], y[w], qj, qneg), qj);
    load_words<W>(kp + key_c, y);
#pragma unroll
    for (int w = 0; w < W; ++w) acc1[w] = add_mod(acc1[w], mont_mul(poly[w], y[w], qj, qneg), qj);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    acc0[w] = mul_shoup(acc0[w], r32, r32s, qj);
    acc1[w] = mul_shoup(acc1[w], r32, r32s, qj);
  }
  store_words<W>(out + (m * J + j) * n + col0, acc0);
  store_words<W>(out + ((M + m) * J + j) * n + col0, acc1);
  cg::this_cluster().sync();
}

}  // namespace

extern "C" int ks_fused(const void* ccoef, const void* cntt, const void* key, const void* own,
                        const void* pw, const void* pws, const void* gather, const void* ip,
                        const void* ips, const void* srcq, const void* q, const void* mont,
                        const void* roots, const void* roots_sh, void* out, int M, int D,
                        int A, int J, int l, int logn, int log_c, int threads, void* stream) {
  return with_cluster_geometry(logn, log_c, threads, [&](auto w, auto lc) {
    constexpr int W = decltype(w)::value, LC = decltype(lc)::value;
    return launch_cluster(ks_fused_kernel<W, LC>, (long long)M * J, LC, threads,
                          sizeof(uint32_t) * W * threads, (cudaStream_t)stream,
                          (const uint32_t*)ccoef, (const uint32_t*)cntt, (const uint32_t*)key,
                          (const int*)own, (const uint32_t*)pw, (const uint32_t*)pws,
                          (const int*)gather, (const uint32_t*)ip, (const uint32_t*)ips,
                          (const uint32_t*)srcq, (const uint32_t*)q, (const uint32_t*)mont,
                          (const uint32_t*)roots, (const uint32_t*)roots_sh, (uint32_t*)out, M,
                          D, A, J, l, logn);
  });
}
