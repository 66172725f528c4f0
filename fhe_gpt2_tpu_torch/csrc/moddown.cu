// HPS mod-down by P in one launch (key-switch mod-down, composite pair
// rescale), for Hopper (sm_90a).
//
// Replaces the TPU kernel fhe_gpt2_tpu/core/tks.py:_md_kernel (entry
// fused_mod_down), which per output limb j converts the dropped limbs,
// corrects the overflow, runs the forward NTT and divides in one Pallas
// program with the limb in VMEM. Here one thread-block cluster per (batch
// m, output limb j) does the same with the limb in the cluster's shared
// memory (ntt_cluster.cuh). Per word n, with a = iNTT of the k dropped
// limbs (ntt.cu, run by the wrapper before this launch), in this order:
//
//   v_i = ((a_i + (P/2 mod p_i)) * (P/p_i)^-1) mod p_i
//   acc = sum_i v_i * (P/p_i mod q_j)                  mod q_j
//   f   = sum_i float(v_i) * (1/p_i)     float32, i = 0..k-1
//   u   = clamp(floor f, 0, k-1)
//   img = acc - u * (P mod q_j) - (P/2 mod q_j)         mod q_j
//   out[m, j] = (x[m, j] - NTT_j(img)) * P^-1          mod q_j
//
// The float32 sum runs sequentially with __fmul_rn / __fadd_rn, so no
// fused multiply-add changes f: the plain PyTorch version sums in the same
// order with separate multiply and add, and the two agree bit for bit. The
// [0, k-1] clamp is part of the semantics (it pins k = 1 to u = 0).
//
// What bounds it: the bytes are x (the l kept limbs read in place, the k
// dropped limbs read as their iNTT) and the output, each once from device
// memory (the re-reads of the dropped limbs by the l clusters hit L2); the
// v operand and the img intermediate of the three-launch design no longer
// exist. The arithmetic is 2k Shoup products per output word (v_i and its
// image), 15-16 Shoup butterflies and one Shoup product for P^-1; every product has a
// table word as one factor, so all are Shoup products. img lives in shared
// memory; v, acc and f are formed in registers (W words per thread).
#include "ntt_cluster.cuh"

namespace {

template <int W, int LC>
__global__ void __launch_bounds__(kClusterThreads, cluster_ctas_per_sm(W))
    md_fused_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ halfp, const uint32_t* __restrict__ ip,
                    const uint32_t* __restrict__ ips, const uint32_t* __restrict__ pq,
                    const uint32_t* __restrict__ punc, const uint32_t* __restrict__ puncs,
                    const float* __restrict__ pinvf, const uint32_t* __restrict__ pmodq,
                    const uint32_t* __restrict__ pmodqs, const uint32_t* __restrict__ halfq,
                    const uint32_t* __restrict__ invp, const uint32_t* __restrict__ invps,
                    const uint32_t* __restrict__ q, const uint32_t* __restrict__ roots,
                    const uint32_t* __restrict__ roots_sh, uint32_t* __restrict__ out, int k,
                    int l, int logn) {
  extern __shared__ uint32_t sh[];
  const int n = 1 << logn;
  const long long cid = (long long)(blockIdx.x >> LC);   // m * l + j
  const int j = (int)(cid % l);
  const long long m = cid / l;
  // This thread's W contiguous words of the limb.
  const long long col0 =
      (long long)cg::this_cluster().block_rank() * (blockDim.x * W) + threadIdx.x * W;
  const uint32_t qj = q[j];
  const uint32_t* ap = a + m * k * (long long)n + col0;
  const uint32_t* xp = x + (m * (l + k) + j) * n + col0;
  uint32_t acc[W], v[W];
  float f[W];
  for (int i = 0; i < k; ++i) {
    const uint32_t p = pq[i], hp = halfp[i], iv = ip[i], ivs = ips[i];
    const uint32_t pw = punc[(long long)i * l + j], pws = puncs[(long long)i * l + j];
    const float pf = pinvf[i];
    load_words<W>(ap + (long long)i * n, v);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t vi = mul_shoup(add_mod(v[w], hp, p), iv, ivs, p);
      const uint32_t term = mul_shoup(vi, pw, pws, qj);
      const float fi = __fmul_rn(__uint2float_rn(vi), pf);
      acc[w] = i == 0 ? term : add_mod(acc[w], term, qj);
      f[w] = i == 0 ? fi : __fadd_rn(f[w], fi);
    }
  }
  const uint32_t pm = pmodq[j], pms = pmodqs[j], hq = halfq[j];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const float fl = fminf(fmaxf(floorf(f[w]), 0.0f), (float)(k - 1));
    const uint32_t r = sub_mod(acc[w], mul_shoup((uint32_t)fl, pm, pms, qj), qj);
    acc[w] = sub_mod(r, hq, qj);
  }
  cluster_ntt_fwd<W, LC>(sh, acc, logn, roots + (long long)j * n,
                         roots_sh + (long long)j * n, qj);
  load_words<W>(xp, v);
  const uint32_t w0 = invp[j], w0s = invps[j];
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = mul_shoup(sub_mod(v[w], acc[w], qj), w0, w0s, qj);
  store_words<W>(out + (m * l + j) * n + col0, v);
  cg::this_cluster().sync();
}

}  // namespace

extern "C" int md_fused(const void* a, const void* x, const void* halfp, const void* ip,
                        const void* ips, const void* pq, const void* punc, const void* puncs,
                        const void* pinvf, const void* pmodq, const void* pmodqs,
                        const void* halfq, const void* invp, const void* invps, const void* q,
                        const void* roots, const void* roots_sh, void* out, int M, int k, int l,
                        int logn, int log_c, int threads, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  return with_cluster_geometry(logn, log_c, threads, [&](auto w, auto lc) {
    constexpr int W = decltype(w)::value, LC = decltype(lc)::value;
    return launch_cluster(md_fused_kernel<W, LC>, (long long)M * l, LC, threads,
                          sizeof(uint32_t) * W * threads, (cudaStream_t)stream,
                          (const uint32_t*)a, (const uint32_t*)x, (const uint32_t*)halfp,
                          (const uint32_t*)ip, (const uint32_t*)ips, (const uint32_t*)pq,
                          (const uint32_t*)punc, (const uint32_t*)puncs, (const float*)pinvf,
                          (const uint32_t*)pmodq, (const uint32_t*)pmodqs,
                          (const uint32_t*)halfq, (const uint32_t*)invp, (const uint32_t*)invps,
                          (const uint32_t*)q, (const uint32_t*)roots, (const uint32_t*)roots_sh,
                          (uint32_t*)out, k, l, logn);
  });
}
