// Coefficient-wise modular arithmetic of the evaluator, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this arithmetic to XLA (the
// mul_mod, add_mod, sub_mod, neg_mod and mod_sum of its core/modmath.py and
// core/evaluator.py), and the port's torch route widened every int32 word to
// int64, multiplied, took an int64 remainder by q broadcast over the limbs
// and narrowed: five launches and about 19 operand-sizes of device traffic
// for one product, and the adds were four or five int32 launches each. Three
// entries (core/tdyadic.py), over rows of N residues, row j of a limb with
// modulus q_j < 2^31:
//
//   dyadic_tensor  d0 = a0 b0, d1 = a0 b1 + a1 b0, d2 = a1 b1: the tensor
//                  product of two ciphertexts, written as [3, M, l, N]
//                  (a square reads each component once);
//   dyadic_binary  out = a b, a + b, a - b or -a, with b rows of its own,
//                  rows broadcast over batch rows (a plaintext), or one word
//                  a row (a per-limb constant); output components after the
//                  first are copied from a third operand, so that a
//                  ciphertext whose c0 changes is written in one launch;
//   dyadic_sum     out[o, i] = sum_s x[o, s, i]: a batch axis summed.
//
// Arithmetic. Residues stay in 32-bit registers. Operands below 2^31 (the
// canonical residues, and lazy words in [0, 2q) where 2q < 2^31) give
// products below 2^62; d1's two products are summed in 64 bits (below
// 2^63), and a sum of S < 2^32 words below 2^31 stays below 2^63; each is
// reduced once by reduce64 (modarith.cuh) with the NTT tables' Barrett
// words floor(2^64/q), which gives the canonical residue: the word of the
// plain versions' exact int64 remainder. The adds run the plain versions'
// int32 formulas in two's complement (a - (q - b), a - b, q - a, each with
// its one correction), so lazy inputs give the plain versions' words too.
//
// Layout. An operand's word (m_0 .. m_3, j, w) lies at p + sum_g m_g s_g +
// j sj + w: four batch strides (the wrapper merges the batch axes into at
// most four groups; a broadcast axis has stride 0: a ciphertext's
// components and batch axes, with a mask broadcast over some of them), a
// row stride (a limb-prefix view reads in place), and contiguous words.
// Outputs are contiguous.
//
// What bounds it: bytes. Every operand word is read once and every output
// word written once (a tensor product of two 2 x 128-ciphertext batches at
// 50 limbs, N = 2^15, moves 7 polynomials of 0.84 GB, 1.75 ms at 3.35
// TB/s); the arithmetic is at most four 32x32->64-bit multiplies and a
// reduction a word. A CTA of T threads takes B = 8T words of one row, so the
// row's modulus, its Barrett words and its offsets are resolved once a CTA;
// each thread moves two groups of 4 consecutive words, one 16-byte access
// each (the wrapper checks that every row starts on 16 bytes). Rows x N/B
// CTAs fill the 132 SMs at every shape the evaluator gives (9 rows or more
// at N = 2^15).
#include <cuda_runtime.h>
#include <cstdint>
#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;   // most threads a CTA
constexpr int kWords = 8;       // words a thread: two groups of 4
constexpr int kGroups = 4;      // batch groups (core/tdyadic.py GROUPS)

enum Op { kMul = 0, kAdd = 1, kSub = 2, kNeg = 3 };

// An operand in host words: p, s_0 .. s_3, sj.
constexpr int kOperandWords = kGroups + 2;

struct Operand {
  const uint32_t* p;
  long long s[kGroups], sj;
};

// dyadic_binary's arguments, read from 3 * kOperandWords + 6 + kGroups + 2
// = 30 host words in this order.
struct BinaryArgs {
  Operand a, b, rest;
  long long rest_c;                // rest's component stride
  uint32_t* out;                   // [K, M_0 .. M_3, l, n]
  const uint32_t *q, *r0, *r1;     // [l] each
  long long K, M[kGroups], l, n;
};

// dyadic_tensor's arguments, read from 2 * kOperandWords + 6 + kGroups + 2
// = 24 host words in this order.
struct TensorArgs {
  Operand a;
  long long ac;                    // a's component stride
  Operand b;
  long long bc;
  uint32_t* out;                   // [3, M_0 .. M_3, l, n]
  const uint32_t *q, *r0, *r1;
  long long M[kGroups], l, n;
};

// dyadic_sum's arguments, read from 13 host words in this order: x's word
// (o, s, i, w) lies at x + o so + s ss + i sr + w; row i is limb i mod l.
struct SumArgs {
  const uint32_t* x;
  long long so, ss, sr, S;
  uint32_t* out;                   // [O, R, n]
  const uint32_t *q, *r0, *r1;
  long long O, R, l, n;
};

// The CTA's output row and the first word o0 of its block; rows outer,
// blocks inner.
struct Place {
  long long row, o0;
};

__device__ __forceinline__ Place place(long long n) {
  const long long B = kWords * blockDim.x;
  const long long blocks = n / B;
  return {blockIdx.x / blocks, (blockIdx.x % blocks) * B};
}

// A row of [.., M_0 .. M_3, l] split into (c, m_0 .. m_3, j).
struct RowIx {
  long long c, m[kGroups], j;
};

__device__ __forceinline__ RowIx split(long long row, const long long (&M)[kGroups],
                                       long long l) {
  RowIx r;
  r.j = row % l;
  long long m = row / l;
#pragma unroll
  for (int g = kGroups - 1; g >= 0; --g) {
    r.m[g] = m % M[g];
    m /= M[g];
  }
  r.c = m;
  return r;
}

__device__ __forceinline__ long long offset(const Operand& x, const RowIx& r) {
  long long o = r.j * x.sj;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) o += r.m[g] * x.s[g];
  return o;
}

__device__ __forceinline__ uint64_t ratio_of(const uint32_t* r0, const uint32_t* r1,
                                             long long j) {
  return ((uint64_t)__ldg(r1 + j) << 32) | __ldg(r0 + j);
}

// This thread's 8 words of the block that starts at p (16-byte aligned),
// read-only for the whole launch.
__device__ __forceinline__ void load8(const uint32_t* p, uint32_t (&x)[kWords]) {
  const uint4 s = __ldg(reinterpret_cast<const uint4*>(p + 4 * threadIdx.x));
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p + 4 * (blockDim.x + threadIdx.x)));
  x[0] = s.x, x[1] = s.y, x[2] = s.z, x[3] = s.w;
  x[4] = t.x, x[5] = t.y, x[6] = t.z, x[7] = t.w;
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t (&x)[kWords]) {
  reinterpret_cast<uint4*>(p + 4 * threadIdx.x)[0] = make_uint4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<uint4*>(p + 4 * (blockDim.x + threadIdx.x))[0] =
      make_uint4(x[4], x[5], x[6], x[7]);
}

template <int kOp, bool kConstB>
__global__ void __launch_bounds__(kThreads) binary_kernel(BinaryArgs g) {
  const Place at = place(g.n);
  const RowIx r = split(at.row, g.M, g.l);
  uint32_t* op = g.out + at.row * g.n + at.o0;
  uint32_t y[kWords];
  if (r.c > 0) {                   // a component copied through
    load8(g.rest.p + (r.c - 1) * g.rest_c + offset(g.rest, r) + at.o0, y);
    store8(op, y);
    return;
  }
  const uint32_t q = __ldg(g.q + r.j);
  uint32_t x[kWords];
  load8(g.a.p + offset(g.a, r) + at.o0, x);
  if (kOp == kNeg) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) y[k] = x[k] == 0 ? 0u : q - x[k];
    store8(op, y);
    return;
  }
  uint32_t w[kWords];
  if (kConstB) {
    const uint32_t c = __ldg(g.b.p + offset(g.b, r));
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = c;
  } else {
    load8(g.b.p + offset(g.b, r) + at.o0, w);
  }
  if (kOp == kMul) {
    const uint64_t ratio = ratio_of(g.r0, g.r1, r.j);
#pragma unroll
    for (int k = 0; k < kWords; ++k) y[k] = reduce64((uint64_t)x[k] * w[k], ratio, q);
  } else if (kOp == kAdd) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint32_t s = x[k] - (q - w[k]);
      y[k] = (int32_t)s < 0 ? s + q : s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint32_t d = x[k] - w[k];
      y[k] = (int32_t)d < 0 ? d + q : d;
    }
  }
  store8(op, y);
}

template <bool kSquare>
__global__ void __launch_bounds__(kThreads) tensor_kernel(TensorArgs g) {
  const Place at = place(g.n);
  const RowIx r = split(at.row, g.M, g.l);
  const uint32_t q = __ldg(g.q + r.j);
  const uint64_t ratio = ratio_of(g.r0, g.r1, r.j);
  const uint32_t* ap = g.a.p + offset(g.a, r) + at.o0;
  uint32_t a0[kWords], a1[kWords], b0[kWords], b1[kWords];
  load8(ap, a0);
  load8(ap + g.ac, a1);
  if (!kSquare) {
    const uint32_t* bp = g.b.p + offset(g.b, r) + at.o0;
    load8(bp, b0);
    load8(bp + g.bc, b1);
  }
  uint32_t d0[kWords], d1[kWords], d2[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    if (kSquare) {
      const uint64_t m = (uint64_t)a0[k] * a1[k];
      d0[k] = reduce64((uint64_t)a0[k] * a0[k], ratio, q);
      d1[k] = reduce64(m + m, ratio, q);
      d2[k] = reduce64((uint64_t)a1[k] * a1[k], ratio, q);
    } else {
      d0[k] = reduce64((uint64_t)a0[k] * b0[k], ratio, q);
      d1[k] = reduce64((uint64_t)a0[k] * b1[k] + (uint64_t)a1[k] * b0[k], ratio, q);
      d2[k] = reduce64((uint64_t)a1[k] * b1[k], ratio, q);
    }
  }
  long long plane = g.l * g.n;                 // one output component
#pragma unroll
  for (int i = 0; i < kGroups; ++i) plane *= g.M[i];
  uint32_t* op = g.out + at.row * g.n + at.o0;
  store8(op, d0);
  store8(op + plane, d1);
  store8(op + 2 * plane, d2);
}

__global__ void __launch_bounds__(kThreads) sum_kernel(SumArgs g) {
  const Place at = place(g.n);
  const long long i = at.row % g.R, o = at.row / g.R, j = i % g.l;
  const uint32_t* xp = g.x + o * g.so + i * g.sr + at.o0;
  uint64_t acc[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) acc[k] = 0;
  for (long long s = 0; s < g.S; ++s) {
    uint32_t x[kWords];
    load8(xp + s * g.ss, x);
#pragma unroll
    for (int k = 0; k < kWords; ++k) acc[k] += x[k];
  }
  const uint32_t q = __ldg(g.q + j);
  const uint64_t ratio = ratio_of(g.r0, g.r1, j);
  uint32_t y[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) y[k] = reduce64(acc[k], ratio, q);
  store8(g.out + at.row * g.n + at.o0, y);
}

// The grid of rows x (n / 8T) CTAs of T threads, in x; 0 CTAs where there is
// no row; an error where T or n do not fit.
int grid_of(long long rows, long long n, int threads, dim3* grid) {
  if (threads <= 0 || threads > kThreads || n <= 0 || n % (kWords * threads) != 0)
    return (int)cudaErrorInvalidValue;
  const long long ctas = rows * (n / (kWords * threads));
  if (rows < 0 || ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)ctas);
  return 0;
}

Operand operand(const long long* w) {
  Operand x;
  x.p = (const uint32_t*)w[0];
  for (int g = 0; g < kGroups; ++g) x.s[g] = w[1 + g];
  x.sj = w[1 + kGroups];
  return x;
}

// The batch rows M_0 .. M_3 from w; their product, or -1 where one is < 1.
long long batch_of(const long long* w, long long (&M)[kGroups]) {
  long long rows = 1;
  for (int g = 0; g < kGroups; ++g) {
    M[g] = w[g];
    if (M[g] < 1) return -1;
    rows *= M[g];
  }
  return rows;
}

template <int kOp>
void launch_binary(const BinaryArgs& g, bool const_b, dim3 grid, int threads,
                   cudaStream_t stream) {
  if (const_b)
    binary_kernel<kOp, true><<<grid, threads, 0, stream>>>(g);
  else
    binary_kernel<kOp, false><<<grid, threads, 0, stream>>>(g);
}

}  // namespace

// words: the 30 fields of BinaryArgs in order (operands as p, s_0 .. s_3,
// sj);
// op: 0 multiply, 1 add, 2 subtract, 3 negate (b not read); const_b: b is
// one word a row.
extern "C" int dyadic_binary(const void* words, int op, int const_b, int threads,
                             void* stream) {
  const long long* w = (const long long*)words;
  BinaryArgs g;
  g.a = operand(w);
  g.b = operand(w + kOperandWords);
  g.rest = operand(w + 2 * kOperandWords);
  w += 3 * kOperandWords;
  g.rest_c = w[0];
  g.out = (uint32_t*)w[1];
  g.q = (const uint32_t*)w[2];
  g.r0 = (const uint32_t*)w[3];
  g.r1 = (const uint32_t*)w[4];
  g.K = w[5];
  const long long rows = batch_of(w + 6, g.M);
  g.l = w[6 + kGroups], g.n = w[7 + kGroups];
  if (g.K < 1 || rows < 1 || g.l < 0) return (int)cudaErrorInvalidValue;
  dim3 grid;
  if (int e = grid_of(g.K * rows * g.l, g.n, threads, &grid)) return e;
  if (grid.x == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kMul: launch_binary<kMul>(g, const_b, grid, threads, s); break;
    case kAdd: launch_binary<kAdd>(g, const_b, grid, threads, s); break;
    case kSub: launch_binary<kSub>(g, const_b, grid, threads, s); break;
    case kNeg: binary_kernel<kNeg, false><<<grid, threads, 0, s>>>(g); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// words: the 24 fields of TensorArgs in order; square: b is a (not read).
extern "C" int dyadic_tensor(const void* words, int square, int threads, void* stream) {
  const long long* w = (const long long*)words;
  TensorArgs g;
  g.a = operand(w);
  g.ac = w[kOperandWords];
  g.b = operand(w + kOperandWords + 1);
  w += 2 * kOperandWords + 1;
  g.bc = w[0];
  g.out = (uint32_t*)w[1];
  g.q = (const uint32_t*)w[2];
  g.r0 = (const uint32_t*)w[3];
  g.r1 = (const uint32_t*)w[4];
  const long long rows = batch_of(w + 5, g.M);
  g.l = w[5 + kGroups], g.n = w[6 + kGroups];
  if (rows < 1 || g.l < 0) return (int)cudaErrorInvalidValue;
  dim3 grid;
  if (int e = grid_of(rows * g.l, g.n, threads, &grid)) return e;
  if (grid.x == 0) return 0;
  if (square)
    tensor_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(g);
  else
    tensor_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// words: the 13 fields of SumArgs in order.
extern "C" int dyadic_sum(const void* words, int threads, void* stream) {
  const long long* w = (const long long*)words;
  SumArgs g;
  g.x = (const uint32_t*)w[0];
  g.so = w[1], g.ss = w[2], g.sr = w[3], g.S = w[4];
  g.out = (uint32_t*)w[5];
  g.q = (const uint32_t*)w[6];
  g.r0 = (const uint32_t*)w[7];
  g.r1 = (const uint32_t*)w[8];
  g.O = w[9], g.R = w[10], g.l = w[11], g.n = w[12];
  if (g.O < 1 || g.R < 0 || g.l < 1 || g.S < 0 || g.S >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  if (int e = grid_of(g.O * g.R, g.n, threads, &grid)) return e;
  if (grid.x == 0) return 0;
  sum_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
