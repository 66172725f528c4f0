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

// Barrett: a*b mod q for any a, b < 2^31, with ratio = floor(2^64 / q).
// p < 2^62 gives qhat in {floor(p/q) - 1, floor(p/q)}, so r < 2q.
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b, uint32_t q,
                                            uint64_t ratio) {
  uint64_t p = (uint64_t)a * b;
  uint64_t qhat = __umul64hi(p, ratio);
  uint64_t r = p - qhat * q;
  return (uint32_t)(r >= q ? r - q : r);
}

__device__ __forceinline__ uint64_t barrett_ratio(const uint32_t* r0, const uint32_t* r1,
                                                  int j) {
  return ((uint64_t)r1[j] << 32) | r0[j];
}
