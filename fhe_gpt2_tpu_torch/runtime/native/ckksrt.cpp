// ckksrt — native host runtime of fhe_gpt2_tpu_torch.
//
// The port's copy of fhe_gpt2_tpu/runtime/native/ckksrt.cpp; only this
// comment differs. The device compute path is PyTorch and the CUDA kernels
// in csrc/; this library covers the host-side hot loops that C++ does
// better than numpy. runtime/native.py builds it with g++, contracting
// products into FMAs as numpy's complex multiply does:
//
//   * encode: staged complex inverse-FFT (the same butterfly network as
//     core/embedding.py) + exact rounding + RNS reduction. Used for every
//     plaintext/mask/LT-diagonal encode — thousands per model build.
//   * crt_compose: exact centered CRT composition of a small limb subset to
//     double (the decode path), replacing numpy object-dtype big-int math.
//   * serialization: length-prefixed zlib blobs for keys/ciphertexts.
//
// Counterpart of the reference's CKKSEncoder hot loops (ckks.cpp /
// util/dwthandler.h) and serialization (util/ztools.cpp), reimplemented for
// this framework's orderings. Exposed with a plain C ABI for ctypes.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

using std::size_t;
using cplx = std::complex<double>;

extern "C" {

// ---------------------------------------------------------------------------
// Staged inverse transform (evals -> coefficients), matching
// embedding.coeff_transform: for s = logn-1..0: blocks [m,2,half],
// u' = u+v, v' = (u-v)*tw[s][i]; final scale 1/n.
// twiddles: concatenated per-stage tables, stage s has m=2^s entries.
// ---------------------------------------------------------------------------
void ckksrt_coeff_transform(double* re, double* im, int64_t n,
                            const double* tw_re, const double* tw_im) {
  int logn = 0;
  while ((1LL << logn) < n) logn++;
  for (int s = logn - 1; s >= 0; --s) {
    int64_t m = 1LL << s;
    int64_t half = n >> (s + 1);
    const double* wr = tw_re + m;  // stage s entries live at offsets [m, 2m)
    const double* wi = tw_im + m;
    for (int64_t i = 0; i < m; ++i) {
      cplx w(wr[i], wi[i]);
      int64_t base = i * 2 * half;
      for (int64_t j = 0; j < half; ++j) {
        cplx u(re[base + j], im[base + j]);
        cplx v(re[base + half + j], im[base + half + j]);
        cplx a = u + v;
        cplx b = (u - v) * w;
        re[base + j] = a.real();
        im[base + j] = a.imag();
        re[base + half + j] = b.real();
        im[base + half + j] = b.imag();
      }
    }
  }
  double inv = 1.0 / static_cast<double>(n);
  for (int64_t i = 0; i < n; ++i) {
    re[i] *= inv;
    im[i] *= inv;
  }
}

// Round real parts and reduce into k RNS moduli. coeff magnitudes must be
// < 2^62 (the encoder guards this host-side).
void ckksrt_round_to_rns(const double* re, int64_t n, const uint64_t* moduli,
                         int64_t k, uint64_t* out /* [k][n] */) {
  for (int64_t i = 0; i < n; ++i) {
    double r = std::nearbyint(re[i]);
    int64_t v = static_cast<int64_t>(r);
    for (int64_t q = 0; q < k; ++q) {
      int64_t m = static_cast<int64_t>(moduli[q]);
      int64_t x = v % m;
      if (x < 0) x += m;
      out[q * n + i] = static_cast<uint64_t>(x);
    }
  }
}

// ---------------------------------------------------------------------------
// Exact centered CRT composition of k limbs to double / scale.
// Small fixed-size bignum (little-endian 64-bit words).
// ---------------------------------------------------------------------------
namespace {
constexpr int MAXW = 10;
struct Big {
  uint64_t w[MAXW] = {0};
  int nw = 1;
};

void big_mul_small(Big& a, uint64_t m) {
  unsigned __int128 carry = 0;
  for (int i = 0; i < a.nw; ++i) {
    unsigned __int128 p = (unsigned __int128)a.w[i] * m + carry;
    a.w[i] = (uint64_t)p;
    carry = p >> 64;
  }
  while (carry && a.nw < MAXW) {
    a.w[a.nw++] = (uint64_t)carry;
    carry >>= 64;
  }
}

void big_add(Big& a, const Big& b) {
  unsigned __int128 carry = 0;
  int n = b.nw > a.nw ? b.nw : a.nw;
  for (int i = 0; i < n; ++i) {
    unsigned __int128 s = (unsigned __int128)a.w[i] + (i < b.nw ? b.w[i] : 0) + carry;
    a.w[i] = (uint64_t)s;
    carry = s >> 64;
  }
  a.nw = n;
  if (carry && a.nw < MAXW) a.w[a.nw++] = (uint64_t)carry;
}

// a mod m for small m (< 2^63), scanning words top-down.
uint64_t big_mod_small(const Big& a, uint64_t m) {
  unsigned __int128 r = 0;
  for (int i = a.nw - 1; i >= 0; --i) {
    r = ((r << 64) | a.w[i]) % m;
  }
  return (uint64_t)r;
}

int big_cmp(const Big& a, const Big& b) {
  int n = a.nw > b.nw ? a.nw : b.nw;
  for (int i = n - 1; i >= 0; --i) {
    uint64_t x = i < a.nw ? a.w[i] : 0, y = i < b.nw ? b.w[i] : 0;
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

void big_sub(Big& a, const Big& b) {  // a -= b, requires a >= b
  unsigned __int128 borrow = 0;
  for (int i = 0; i < a.nw; ++i) {
    unsigned __int128 y = (i < b.nw ? b.w[i] : 0) + borrow;
    if ((unsigned __int128)a.w[i] >= y) {
      a.w[i] = (uint64_t)((unsigned __int128)a.w[i] - y);
      borrow = 0;
    } else {
      a.w[i] = (uint64_t)(((unsigned __int128)1 << 64) + a.w[i] - y);
      borrow = 1;
    }
  }
}

double big_to_double(const Big& a) {
  double out = 0.0;
  for (int i = a.nw - 1; i >= 0; --i) out = out * 18446744073709551616.0 + (double)a.w[i];
  return out;
}
}  // namespace

// residues: [k][n] coefficient-domain; out: centered value / scale.
void ckksrt_crt_compose(const uint64_t* residues, int64_t k, int64_t n,
                        const uint64_t* moduli, double scale, double* out) {
  // Precompute P, punc_i = P/q_i, inv_i = punc_i^{-1} mod q_i.
  Big P;
  P.w[0] = 1;
  for (int64_t i = 0; i < k; ++i) big_mul_small(P, moduli[i]);
  std::vector<Big> punc(k);
  std::vector<uint64_t> inv(k);
  for (int64_t i = 0; i < k; ++i) {
    Big p;
    p.w[0] = 1;
    for (int64_t j = 0; j < k; ++j)
      if (j != i) big_mul_small(p, moduli[j]);
    punc[i] = p;
    uint64_t pm = big_mod_small(p, moduli[i]);
    // Modular inverse via extended Euclid on uint64.
    int64_t t = 0, newt = 1;
    int64_t r = (int64_t)moduli[i], newr = (int64_t)pm;
    while (newr != 0) {
      int64_t qu = r / newr;
      int64_t tmp = t - qu * newt; t = newt; newt = tmp;
      tmp = r - qu * newr; r = newr; newr = tmp;
    }
    if (t < 0) t += (int64_t)moduli[i];
    inv[i] = (uint64_t)t;
  }
  Big halfP = P;  // P/2 via shift-right by 1
  {
    uint64_t carry = 0;
    for (int i = halfP.nw - 1; i >= 0; --i) {
      uint64_t cur = halfP.w[i];
      halfP.w[i] = (cur >> 1) | (carry << 63);
      carry = cur & 1;
    }
  }
  for (int64_t c = 0; c < n; ++c) {
    Big acc;
    for (int64_t i = 0; i < k; ++i) {
      uint64_t t = (uint64_t)(((unsigned __int128)residues[i * n + c] * inv[i]) % moduli[i]);
      Big term = punc[i];
      big_mul_small(term, t);
      big_add(acc, term);
    }
    // acc mod P (acc < k*P, so a few subtractions suffice)
    while (big_cmp(acc, P) >= 0) big_sub(acc, P);
    if (big_cmp(acc, halfP) > 0) {
      Big neg = P;
      big_sub(neg, acc);
      out[c] = -big_to_double(neg) / scale;
    } else {
      out[c] = big_to_double(acc) / scale;
    }
  }
}

// ---------------------------------------------------------------------------
// zlib blob helpers
// ---------------------------------------------------------------------------
int64_t ckksrt_compress_bound(int64_t n) { return compressBound((uLong)n); }

int64_t ckksrt_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
  uLongf dlen = (uLongf)cap;
  if (compress2(dst, &dlen, src, (uLong)n, 6) != Z_OK) return -1;
  return (int64_t)dlen;
}

int64_t ckksrt_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap) {
  uLongf dlen = (uLongf)cap;
  if (uncompress(dst, &dlen, src, (uLong)n) != Z_OK) return -1;
  return (int64_t)dlen;
}

}  // extern "C"
