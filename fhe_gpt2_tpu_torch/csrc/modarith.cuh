// Device modular arithmetic for the uint32 RNS-CKKS engine.
//
// Every modulus q is below 2^31, so a + b of two residues fits a uint32 and
// one conditional subtraction brings any result below q. All functions
// return the canonical residue in [0, q): the kernels equal the plain
// PyTorch versions (which reduce the exact int64 product) bit for bit.
#pragma once
#include <cstdint>

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// Shoup: a*w mod q for any a < 2^32, w < q, ws = floor(w * 2^32 / q).
// a*w - qhat*q lies in [0, 2q), computed in wrapping uint32.
__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w, uint32_t ws,
                                              uint32_t q) {
  uint32_t qhat = __umulhi(a, ws);
  uint32_t r = a * w - qhat * q;
  return r >= q ? r - q : r;
}

// acc mod q for any 64-bit acc; ratio = floor(2^64 / q), the NTT tables'
// Barrett words (ratio1 << 32 | ratio0). The quotient estimate
// floor(acc * ratio / 2^64) is at most one below floor(acc / q), so the
// remainder lies in [0, 2q) before one conditional subtraction.
__device__ __forceinline__ uint32_t reduce64(uint64_t acc, uint64_t ratio, uint32_t q) {
  const uint64_t r = acc - __umul64hi(acc, ratio) * q;
  return (uint32_t)(r >= q ? r - q : r);
}

// Montgomery: a*b*2^-32 mod q for a, b < q < 2^31, qneg = -q^-1 mod 2^32.
// t = a*b + m*q is a multiple of 2^32 below 2^63, and t / 2^32 < q^2/2^32 + q
// < 1.5q, so one conditional subtraction makes it canonical.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t q, uint32_t qneg) {
  const uint64_t p = (uint64_t)a * b;
  const uint32_t m = (uint32_t)p * qneg;
  const uint32_t r = (uint32_t)((p + (uint64_t)m * q) >> 32);
  return r >= q ? r - q : r;
}
