// Modular multiply-accumulates of the LT engine's double-hoisted path, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these sums to XLA
// (_ks_mac_core in fhe_gpt2_tpu/core/evaluator.py, the stacked mul_mod +
// mod_sum of its nn/backend.py), and the port's torch route widened every
// int32 word to int64, multiplied, took an int64 remainder, narrowed, and
// widened again to sum. Three entries (core/tks.py hoisted_mac, add_lifted,
// masked_sum), over the residues of rows j with moduli q_j < 2^31:
//
//   hoisted_mac  out[c, m, j, n] = sum_d tpoly[m, d, j, perm[n]] * key[c, d, j, n]
//                for c = 0, 1: a hoisted rotation's key product, with the
//                Galois gather of the shared digits done here;
//   add_lifted   out[m, j, n] += P_j * c0[m, j, perm[n]] for the data rows j < r,
//                in place: the rotated c0, lifted into the extended basis,
//                added to the first component of a hoisted key product;
//   masked_sum   out[c, m, j, n] = sum_t v_t[c, m, j, n] * p_t[j, n] over up to
//                kTerms terms a launch, plus out where a launch accumulates
//                onto the one before.
//
// Arithmetic. Operands are canonical residues, so a product is below
// q^2 < 2^62. A sum is kept in 64 bits below 2q^2: after each product
// (sum + product < 3q^2 < 2^64) 2q^2 is subtracted where the sum reaches
// it. One Barrett reduction with floor(2^64/q) (the NTT tables' ratio
// words) ends it: its quotient estimate is at most one below the quotient,
// so one conditional subtraction gives the canonical residue, the word the
// plain versions' exact int64 remainders give.
//
// What bounds it: bytes. Every operand word is read once and every output
// word written once (a hoisted MAC at D = 5 digits, J = 96 rows, N = 2^15
// moves 214 MB, 64 us at 3.35 TB/s; an 8-term masked sum at J = 96 moves
// 327 MB); the arithmetic is one 32x32->64-bit multiply, an add and a
// compare per product. A CTA of T threads takes an output block of B = 8T
// words of one row (m, j); each thread holds two groups of 4 consecutive
// words, so every load and store of the key, the terms, the masks and the
// output is one 16-byte access per group (the wrappers check that every
// row starts on 16 bytes), and the sums of a word stay in registers over
// all digits or terms.
//
// The Galois gather. X -> X^g multiplies the odd exponent 2 br(i) + 1 of
// NTT slot i by g mod 2N; the low bits of a product depend on the low bits
// of its factor alone, and those are the high bits of i. So perm maps each
// aligned block of B slots onto one aligned block of B slots. A CTA stages
// that source block of each digit row in shared memory with 16-byte
// coalesced loads and gathers from there; a perm entry outside the staged
// block (a permutation without this structure) is read from device memory,
// so the result is exact for any permutation.
#include <cuda_runtime.h>
#include <cstdint>
#include "modarith.cuh"

namespace {

constexpr int kTerms = 8;       // masked-sum terms a launch (core/tks.py MAC_CHUNK)
constexpr int kThreads = 256;   // most threads a CTA
constexpr int kWords = 8;       // output words a thread: two groups of 4

// The terms of one masked-sum launch, by value: term t's word (c, m, j, n)
// is v[t][c * vc[t] + m * vm[t] + j * vj[t] + n], its mask's p[t][j * pj[t] + n].
struct Terms {
  const uint32_t* v[kTerms];
  const uint32_t* p[kTerms];
  long long vc[kTerms], vm[kTerms], vj[kTerms], pj[kTerms];
};

// Offset of this thread's word k (0..7) in its CTA's block.
__device__ __forceinline__ int word_of(int k) {
  return (k >> 2) * 4 * (int)blockDim.x + 4 * (int)threadIdx.x + (k & 3);
}

// This thread's 8 words of the block that starts at p (16-byte aligned). RO:
// read-only for the whole launch (the non-coherent cache may serve it).
template <bool RO = true>
__device__ __forceinline__ void load8(const uint32_t* p, uint32_t (&x)[kWords]) {
  const uint4* a = reinterpret_cast<const uint4*>(p + 4 * threadIdx.x);
  const uint4* b = reinterpret_cast<const uint4*>(p + 4 * (blockDim.x + threadIdx.x));
  const uint4 s = RO ? __ldg(a) : *a;
  const uint4 t = RO ? __ldg(b) : *b;
  x[0] = s.x, x[1] = s.y, x[2] = s.z, x[3] = s.w;
  x[4] = t.x, x[5] = t.y, x[6] = t.z, x[7] = t.w;
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t (&x)[kWords]) {
  reinterpret_cast<uint4*>(p + 4 * threadIdx.x)[0] = make_uint4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<uint4*>(p + 4 * (blockDim.x + threadIdx.x))[0] =
      make_uint4(x[4], x[5], x[6], x[7]);
}

// The B = 8T words at src (16-byte aligned) into shared memory.
__device__ __forceinline__ void stage(uint32_t* sh, const uint32_t* __restrict__ src, int B) {
  for (int i = 4 * threadIdx.x; i < B; i += 4 * blockDim.x)
    *reinterpret_cast<uint4*>(sh + i) = __ldg(reinterpret_cast<const uint4*>(src + i));
}

// acc + a*b, kept below 2q^2 (two_q2 = 2q^2; acc < 2q^2 and a, b < q).
__device__ __forceinline__ uint64_t mac_lazy(uint64_t acc, uint32_t a, uint32_t b,
                                             uint64_t two_q2) {
  acc += (uint64_t)a * b;
  return acc >= two_q2 ? acc - two_q2 : acc;
}

// The CTA's row (m, j) and the first word o0 of its output block; rows
// outer, blocks inner.
struct Place {
  long long m;
  int j;
  long long o0;
};

__device__ __forceinline__ Place place(int J, int n) {
  const int B = kWords * blockDim.x;
  const long long blocks = n / B;
  const long long row = blockIdx.x / blocks;
  return {row / J, (int)(row % J), (blockIdx.x % blocks) * B};
}

// At least 3 CTAs an SM (at most 85 registers a thread): left free, the
// compiler takes 128 registers for this loop and 2 CTAs fit an SM, which on
// an H100 (700 W) took 0.104 device ms at D = 5, J = 96, N = 2^15 against
// 0.091 at 3 CTAs an SM.
__global__ void __launch_bounds__(kThreads, 3)
    hoisted_mac_kernel(const uint32_t* __restrict__ tpoly, const uint32_t* __restrict__ key,
                       const long long* __restrict__ perm, const uint32_t* __restrict__ q,
                       const uint32_t* __restrict__ r0, const uint32_t* __restrict__ r1,
                       uint32_t* __restrict__ out, int M, int D, int J, int n) {
  extern __shared__ uint32_t sh[];
  const int B = kWords * blockDim.x;
  const Place at = place(J, n);
  const uint32_t qj = q[at.j];
  const uint64_t ratio = ((uint64_t)r1[at.j] << 32) | r0[at.j];
  const uint64_t two_q2 = 2ull * qj * qj;
  // The source block of this output block, and the perm entries of this
  // thread's words as offsets from it (|offset| < n < 2^31).
  const long long base = perm[at.o0] & ~(long long)(B - 1);
  int off[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) off[k] = (int)(perm[at.o0 + word_of(k)] - base);
  const long long kc = (long long)D * J * n;     // key components apart
  uint64_t acc0[kWords], acc1[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) acc0[k] = acc1[k] = 0;
  for (int d = 0; d < D; ++d) {
    const uint32_t* row = tpoly + ((at.m * D + d) * J + at.j) * (long long)n;
    stage(sh, row + base, B);
    __syncthreads();
    const uint32_t* kp = key + ((long long)d * J + at.j) * n + at.o0;
    uint32_t x[kWords], k0[kWords], k1[kWords];
    load8(kp, k0);
    load8(kp + kc, k1);
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      x[k] = (unsigned)off[k] < (unsigned)B ? sh[off[k]] : __ldg(row + base + off[k]);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      acc0[k] = mac_lazy(acc0[k], x[k], k0[k], two_q2);
      acc1[k] = mac_lazy(acc1[k], x[k], k1[k], two_q2);
    }
    __syncthreads();
  }
  uint32_t y0[kWords], y1[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    y0[k] = reduce64(acc0[k], ratio, qj);
    y1[k] = reduce64(acc1[k], ratio, qj);
  }
  uint32_t* op = out + (at.m * J + at.j) * (long long)n + at.o0;
  store8(op, y0);
  store8(op + (long long)M * J * n, y1);
}

__global__ void __launch_bounds__(kThreads)
    add_lifted_kernel(const uint32_t* __restrict__ c0, const long long* __restrict__ perm,
                      const uint32_t* __restrict__ p, const uint32_t* __restrict__ ps,
                      const uint32_t* __restrict__ q, uint32_t* __restrict__ out, int r, int J,
                      int n) {
  extern __shared__ uint32_t sh[];
  const int B = kWords * blockDim.x;
  const Place at = place(r, n);                 // c0 is [M, r, n]; out [M, J, n]
  const uint32_t qj = q[at.j], pj = p[at.j], psj = ps[at.j];
  const long long base = perm[at.o0] & ~(long long)(B - 1);
  const uint32_t* row = c0 + (at.m * r + at.j) * (long long)n;
  stage(sh, row + base, B);
  __syncthreads();
  uint32_t* op = out + (at.m * J + at.j) * (long long)n + at.o0;
  uint32_t y[kWords];
  load8<false>(op, y);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const long long s = perm[at.o0 + word_of(k)];
    const unsigned long long i = (unsigned long long)(s - base);
    const uint32_t x = i < (unsigned long long)B ? sh[i] : __ldg(row + s);
    y[k] = add_mod(y[k], mul_shoup(x, pj, psj, qj), qj);
  }
  store8(op, y);
}

__global__ void __launch_bounds__(kThreads)
    masked_sum_kernel(Terms t, int T, const uint32_t* __restrict__ q,
                      const uint32_t* __restrict__ r0, const uint32_t* __restrict__ r1,
                      uint32_t* __restrict__ out, int M, int J, int n, int accumulate) {
  const Place at = place(J, n);
  const uint32_t qj = q[at.j];
  const uint64_t ratio = ((uint64_t)r1[at.j] << 32) | r0[at.j];
  const uint64_t two_q2 = 2ull * qj * qj;
  uint32_t* op0 = out + (at.m * J + at.j) * (long long)n + at.o0;
  uint32_t* op1 = op0 + (long long)M * J * n;
  uint64_t acc0[kWords], acc1[kWords];
  if (accumulate) {
    uint32_t y0[kWords], y1[kWords];
    load8<false>(op0, y0);
    load8<false>(op1, y1);
#pragma unroll
    for (int k = 0; k < kWords; ++k) acc0[k] = y0[k], acc1[k] = y1[k];
  } else {
#pragma unroll
    for (int k = 0; k < kWords; ++k) acc0[k] = acc1[k] = 0;
  }
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    if (i < T) {
      const uint32_t* v = t.v[i] + at.m * t.vm[i] + at.j * t.vj[i] + at.o0;
      uint32_t w[kWords], x0[kWords], x1[kWords];
      load8(t.p[i] + at.j * t.pj[i] + at.o0, w);
      load8(v, x0);
      load8(v + t.vc[i], x1);
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        acc0[k] = mac_lazy(acc0[k], x0[k], w[k], two_q2);
        acc1[k] = mac_lazy(acc1[k], x1[k], w[k], two_q2);
      }
    }
  }
  uint32_t y0[kWords], y1[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    y0[k] = reduce64(acc0[k], ratio, qj);
    y1[k] = reduce64(acc1[k], ratio, qj);
  }
  store8(op0, y0);
  store8(op1, y1);
}

// The grid of rows x (n / 8T) CTAs of T threads, in x; 0 CTAs where there is
// no row; an error where T or n do not fit.
int grid_of(long long rows, int n, int threads, dim3* grid) {
  if (threads <= 0 || threads > kThreads || n % (kWords * threads) != 0)
    return (int)cudaErrorInvalidValue;
  const long long ctas = rows * (n / (kWords * threads));
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)ctas);
  return 0;
}

}  // namespace

extern "C" int hoisted_mac(const void* tpoly, const void* key, const void* perm, const void* q,
                           const void* r0, const void* r1, void* out, int M, int D, int J, int n,
                           int threads, void* stream) {
  dim3 grid;
  if (int e = grid_of((long long)M * J, n, threads, &grid)) return e;
  if (grid.x == 0) return 0;
  hoisted_mac_kernel<<<grid, threads, sizeof(uint32_t) * kWords * threads,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)tpoly, (const uint32_t*)key, (const long long*)perm, (const uint32_t*)q,
      (const uint32_t*)r0, (const uint32_t*)r1, (uint32_t*)out, M, D, J, n);
  return (int)cudaGetLastError();
}

extern "C" int add_lifted(const void* c0, const void* perm, const void* p, const void* ps,
                          const void* q, void* out, int M, int r, int J, int n, int threads,
                          void* stream) {
  dim3 grid;
  if (int e = grid_of((long long)M * r, n, threads, &grid)) return e;
  if (grid.x == 0) return 0;
  add_lifted_kernel<<<grid, threads, sizeof(uint32_t) * kWords * threads,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)c0, (const long long*)perm, (const uint32_t*)p, (const uint32_t*)ps,
      (const uint32_t*)q, (uint32_t*)out, r, J, n);
  return (int)cudaGetLastError();
}

// terms: 6 * kTerms host int64 words, the fields of Terms in order (the
// pointers, then vc, vm, vj, pj); the first T terms are read.
extern "C" int masked_sum(const void* terms, int T, const void* q, const void* r0,
                          const void* r1, void* out, int M, int J, int n, int threads,
                          int accumulate, void* stream) {
  if (T < 1 || T > kTerms) return (int)cudaErrorInvalidValue;
  dim3 grid;
  if (int e = grid_of((long long)M * J, n, threads, &grid)) return e;
  if (grid.x == 0) return 0;
  const long long* w = (const long long*)terms;
  Terms t;
  for (int i = 0; i < kTerms; ++i) {
    t.v[i] = (const uint32_t*)w[i];
    t.p[i] = (const uint32_t*)w[kTerms + i];
    t.vc[i] = w[2 * kTerms + i];
    t.vm[i] = w[3 * kTerms + i];
    t.vj[i] = w[4 * kTerms + i];
    t.pj[i] = w[5 * kTerms + i];
  }
  masked_sum_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      t, T, (const uint32_t*)q, (const uint32_t*)r0, (const uint32_t*)r1, (uint32_t*)out, M, J,
      n, accumulate);
  return (int)cudaGetLastError();
}
