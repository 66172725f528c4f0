// HPS mod-down by P (key-switch mod-down, composite pair rescale), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel fhe_gpt2_tpu/core/tks.py:_md_kernel (entry
// fused_mod_down), which per output limb j converts the dropped limbs,
// corrects the overflow, runs the forward NTT and divides in one Pallas
// program. Here it is three launches:
//
//   md_convert  per (m, j, n), in this order:
//                 acc = sum_i v_i * (P/p_i mod q_j)             mod q_j
//                 f   = sum_i float(v_i) * (1/p_i)   float32, i = 0..k-1
//                 u   = clamp(floor f, 0, k-1)
//                 img = acc - u * (P mod q_j) - (P/2 mod q_j)   mod q_j
//   (ntt.cu)    forward NTT of img with the output-level tables
//   md_finish   out[m, j, n] = (x[m, j, n] - img_ntt[m, j, n]) * P^-1 mod q_j
//
// The float32 sum runs sequentially with __fmul_rn / __fadd_rn, so no
// fused multiply-add changes f: the plain PyTorch version sums in the same
// order with separate multiply and add, and the two agree bit for bit. The
// [0, k-1] clamp is part of the semantics (it pins k = 1 to u = 0).
//
// What bounds it: memory. md_convert reads k words and writes one per
// output word with k Barrett products; md_finish reads two words and
// writes one with one Shoup product. The design reads v once per output
// limb with coalesced loads and keeps the constants in registers; the img
// round trip through device memory is the cost left for a fused kernel.
#include <cuda_runtime.h>
#include "modarith.cuh"

namespace {

__global__ void convert(const uint32_t* __restrict__ v, const uint32_t* __restrict__ punc,
                        const float* __restrict__ pinvf, const uint32_t* __restrict__ pmodq,
                        const uint32_t* __restrict__ halfq, const uint32_t* __restrict__ q,
                        const uint32_t* __restrict__ r0, const uint32_t* __restrict__ r1,
                        uint32_t* __restrict__ img, int k, int l, int n) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int j = blockIdx.y;
  const long long m = blockIdx.z;
  const uint32_t qj = q[j];
  const uint64_t ratio = barrett_ratio(r0, r1, j);
  const uint32_t* vp = v + m * k * (long long)n + col;
  uint32_t acc = 0;
  float f = 0.0f;
  for (int i = 0; i < k; ++i) {
    uint32_t vi = vp[(long long)i * n];
    acc = add_mod(acc, mul_mod(vi, punc[(long long)i * l + j], qj, ratio), qj);
    float fi = __fmul_rn(__uint2float_rn(vi), pinvf[i]);
    f = i == 0 ? fi : __fadd_rn(f, fi);
  }
  float fl = fminf(fmaxf(floorf(f), 0.0f), (float)(k - 1));
  uint32_t u = (uint32_t)fl;
  uint32_t r = sub_mod(acc, mul_mod(u, pmodq[j], qj, ratio), qj);
  img[(m * l + j) * n + col] = sub_mod(r, halfq[j], qj);
}

__global__ void finish(const uint32_t* __restrict__ x, const uint32_t* __restrict__ z,
                       const uint32_t* __restrict__ invp, const uint32_t* __restrict__ invps,
                       const uint32_t* __restrict__ q, uint32_t* __restrict__ out, int l,
                       int k, int n) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int j = blockIdx.y;
  const long long m = blockIdx.z;
  const uint32_t qj = q[j];
  uint32_t d = sub_mod(x[(m * (l + k) + j) * n + col], z[(m * l + j) * n + col], qj);
  out[(m * l + j) * n + col] = mul_shoup(d, invp[j], invps[j], qj);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int md_convert(const void* v, const void* punc, const void* pinvf,
                          const void* pmodq, const void* halfq, const void* q, const void* r0,
                          const void* r1, void* img, int M, int k, int l, int n,
                          void* stream) {
  dim3 grid((n + kThreads - 1) / kThreads, l, M);
  convert<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)v, (const uint32_t*)punc, (const float*)pinvf, (const uint32_t*)pmodq,
      (const uint32_t*)halfq, (const uint32_t*)q, (const uint32_t*)r0, (const uint32_t*)r1,
      (uint32_t*)img, k, l, n);
  return (int)cudaGetLastError();
}

extern "C" int md_finish(const void* x, const void* z, const void* invp, const void* invps,
                         const void* q, void* out, int M, int l, int k, int n, void* stream) {
  dim3 grid((n + kThreads - 1) / kThreads, l, M);
  finish<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)z, (const uint32_t*)invp, (const uint32_t*)invps,
      (const uint32_t*)q, (uint32_t*)out, l, k, n);
  return (int)cudaGetLastError();
}
