// Hybrid key switch, convert and key-MAC halves, for Hopper (sm_90a).
//
// Replaces the TPU kernel fhe_gpt2_tpu/core/tks.py:_ks_kernel (entry
// fused_switch_key), which in one Pallas program per (batch, key limb j,
// digit d, source limb a) accumulates the base-conversion MAC, runs the
// forward NTT of limb j, splices the digit's own limbs and multiplies by
// the key. Here it is three launches:
//
//   ks_convert_mac  t[m, d, j, n] = sum_a y[m, d, a, n] * pw[d, j, a] mod q_j
//   (ntt.cu)        forward NTT of t with the key-basis tables
//   ks_key_mac      out[c, m, j, n] = sum_d poly[d] * key[c, d, j, n] mod q_j,
//                   poly[d] = own[d, j] ? c_ntt[m, j, n] : t[m, d, j, n]
//
// What bounds it: memory. Per output word ks_convert_mac does A Barrett
// products (three 64-bit multiplies each) for 4(A+1) bytes; ks_key_mac
// does 2D products for 4(3D+2) bytes. Both sit far below the integer rate,
// so the least time is the traffic: y, the t intermediate (written, then
// read by the NTT and by ks_key_mac: 11.8 MB at logN=15, l=22, D=3, J=30)
// and the key. The design reads each input once with coalesced 4-byte
// loads (one thread per coefficient, the digit or source loop inside the
// thread) and keeps the constants in registers; the t round trip through
// device memory is the cost it leaves for a fused one-launch kernel.
//
// c_ntt is read only where digit d owns limb j, which holds only for data
// limbs (j < l): the special limbs never read past c_ntt's l rows.
#include <cuda_runtime.h>
#include "modarith.cuh"

namespace {

__global__ void convert_mac(const uint32_t* __restrict__ y, const uint32_t* __restrict__ pw,
                            const uint32_t* __restrict__ q, const uint32_t* __restrict__ r0,
                            const uint32_t* __restrict__ r1, uint32_t* __restrict__ t,
                            int D, int A, int J, int n) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int j = blockIdx.y;
  const long long md = blockIdx.z;              // m * D + d
  const int d = (int)(md % D);
  const uint32_t qj = q[j];
  const uint64_t ratio = barrett_ratio(r0, r1, j);
  const uint32_t* yp = y + md * A * (long long)n + col;
  const uint32_t* w = pw + ((long long)d * J + j) * A;
  uint32_t acc = 0;
  for (int a = 0; a < A; ++a)
    acc = add_mod(acc, mul_mod(yp[(long long)a * n], w[a], qj, ratio), qj);
  t[(md * J + j) * n + col] = acc;
}

__global__ void key_mac(const uint32_t* __restrict__ cntt, const uint32_t* __restrict__ t,
                        const uint32_t* __restrict__ key, const int* __restrict__ own,
                        const uint32_t* __restrict__ q, const uint32_t* __restrict__ r0,
                        const uint32_t* __restrict__ r1, uint32_t* __restrict__ out,
                        int M, int D, int J, int l, int n) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int j = blockIdx.y;
  const long long m = blockIdx.z;
  const uint32_t qj = q[j];
  const uint64_t ratio = barrett_ratio(r0, r1, j);
  const long long key_c = (long long)D * J * n;  // stride between components
  uint32_t acc0 = 0, acc1 = 0;
  for (int d = 0; d < D; ++d) {
    uint32_t poly = (j < l && own[d * J + j])
                        ? cntt[(m * l + j) * n + col]
                        : t[((m * D + d) * J + j) * n + col];
    long long k = ((long long)d * J + j) * n + col;
    acc0 = add_mod(acc0, mul_mod(poly, key[k], qj, ratio), qj);
    acc1 = add_mod(acc1, mul_mod(poly, key[key_c + k], qj, ratio), qj);
  }
  out[(m * J + j) * n + col] = acc0;
  out[((M + m) * J + j) * n + col] = acc1;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int ks_convert_mac(const void* y, const void* pw, const void* q, const void* r0,
                              const void* r1, void* t, int M, int D, int A, int J, int n,
                              void* stream) {
  dim3 grid((n + kThreads - 1) / kThreads, J, M * D);
  convert_mac<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)y, (const uint32_t*)pw, (const uint32_t*)q, (const uint32_t*)r0,
      (const uint32_t*)r1, (uint32_t*)t, D, A, J, n);
  return (int)cudaGetLastError();
}

extern "C" int ks_key_mac(const void* cntt, const void* t, const void* key, const void* own,
                          const void* q, const void* r0, const void* r1, void* out, int M,
                          int D, int J, int l, int n, void* stream) {
  dim3 grid((n + kThreads - 1) / kThreads, J, M);
  key_mac<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cntt, (const uint32_t*)t, (const uint32_t*)key, (const int*)own,
      (const uint32_t*)q, (const uint32_t*)r0, (const uint32_t*)r1, (uint32_t*)out, M, D, J, l,
      n);
  return (int)cudaGetLastError();
}
