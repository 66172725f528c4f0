"""NTT-friendly prime generation and modular number theory (host side).

Pure-Python helpers used at context-construction time only; nothing here runs
on device. Functional parity with the reference's modulus-chain construction
(seal-modified-3.6.6 ``util/numth.h`` / ``modulus.cpp`` semantics): primes are
congruent to 1 mod 2N so the negacyclic NTT exists, found descending from
2**bits.
"""

from __future__ import annotations

import random

_MR_BASES_64 = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit values)."""
    if n < 2:
        return False
    for p in _MR_BASES_64:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES_64:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_primes(bits: int, count: int, two_n: int, below: int | None = None) -> list[int]:
    """`count` primes p ≡ 1 (mod two_n), p < 2**bits, descending from 2**bits.

    Matches SEAL's ``get_primes`` search direction so parameter sets built
    with the same (bits, N) land on the same moduli.
    """
    out: list[int] = []
    # Largest candidate ≡ 1 mod two_n strictly below the start point.
    start = (below if below is not None else (1 << bits)) - 1
    candidate = start - (start % two_n) + 1
    if candidate > start:
        candidate -= two_n
    while len(out) < count:
        if candidate <= two_n:
            raise ValueError(f"ran out of {bits}-bit primes = 1 mod {two_n}")
        if is_prime(candidate):
            out.append(candidate)
        candidate -= two_n
    return out


def gen_primes_balanced(log_scale: int, count: int, two_n: int,
                        exclude: set | None = None) -> list[int]:
    """`count` NTT-friendly primes alternating just-above/just-below
    2**log_scale, chosen greedily so the cumulative log2 drift
    Σ(log2 p_i − log_scale) stays minimal.

    SEAL searches downward only (negligible drift at 46-bit scales); at
    uint32-engine scales (~2**25) the candidate spacing of 2·two_n is a
    relative 2**-8, so one-sided selection would drift the tracked scale by
    ~count·2**-8 — balancing keeps every prefix product within one spacing
    of 2**(k·log_scale)."""
    exclude = set(exclude or ())
    target = 1 << log_scale

    def stream(direction: int):
        # direction -1: descending below target; +1: ascending above.
        c = target + 1 if direction > 0 else target - (target % two_n) + 1
        if direction < 0 and c >= target:
            c -= two_n
        while True:
            if c > two_n and is_prime(c) and c not in exclude:
                yield c
            c += direction * two_n

    lo, hi = stream(-1), stream(+1)
    import math
    out: list[int] = []
    drift = 0.0
    for _ in range(count):
        p = next(hi) if drift <= 0 else next(lo)
        out.append(p)
        drift += math.log2(p) - log_scale
    return out


def gen_prime_pairs(log_scale2: int, count: int, two_n: int,
                    exclude: set | None = None,
                    half_bits: int | None = None) -> list[int]:
    """`count` PAIRS of NTT-friendly primes (2·count primes, flat list) with
    each pair's product as close as possible to 2**log_scale2 — the composite
    two-prime scaling chain for the uint32 engine (Δ = q·q′ ≈ 2**50 built
    from <2**31 moduli; the fix for the measured Δ=2**25-grain bootstrap
    noise floor).

    For each pair the first prime alternates just-above/just-below
    2**(log_scale2/2); the partner is the admissible prime nearest
    2**log_scale2 / first. With candidate spacing two_n the product lands
    within a relative ~two_n/2**(log_scale2/2) of the target (≈2**-11 at
    50/2-bit halves, logN=15) — inside rescale_to_scale's drift tolerance,
    and the exact product is tracked in the ciphertext scale anyway."""
    exclude = set(exclude or ())
    half = half_bits if half_bits is not None else log_scale2 // 2
    target2 = 1 << log_scale2
    anchor = 1 << half

    def nearest(t: int) -> int:
        """Admissible prime ≡ 1 mod two_n nearest to t (not excluded)."""
        base = t - (t % two_n) + 1
        for step in range(0, 1 << 16):
            for c in (base + step * two_n, base - step * two_n):
                if c > two_n and is_prime(c) and c not in exclude:
                    return c
        raise ValueError("no admissible prime near target")

    out: list[int] = []
    for _ in range(count):
        # `nearest` searches outward symmetrically and skips excluded
        # primes, so successive pa picks straddle the anchor; pb compensates
        # each pa exactly, keeping every pair product independently ≈ Δ
        # (pair drift does not accumulate across the chain).
        pa = nearest(anchor)
        exclude.add(pa)
        pb = nearest(target2 // pa)
        exclude.add(pb)
        out += [pa, pb]
    return out


def primitive_root(p: int) -> int:
    """Smallest generator of (Z/p)*; p must be prime."""
    phi = p - 1
    factors = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // q, p) != 1 for q in factors):
            return g
        g += 1


def root_of_unity(order: int, p: int) -> int:
    """A primitive `order`-th root of unity mod p (order | p-1 required).

    Uses the minimal such root (smallest integer value) for determinism, like
    SEAL's minimal-root search.
    """
    if (p - 1) % order != 0:
        raise ValueError(f"{order} does not divide {p}-1")
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    # Minimize over all primitive order-th roots: w^k for k coprime to order.
    # order is a power of two here, so odd k.
    best = w
    cur = w
    w2 = pow(w, 2, p)
    for _ in range(order // 2 - 1):
        cur = cur * w2 % p
        if cur < best:
            best = cur
    return best


def _factorize(n: int) -> set[int]:
    """Prime factors of n (Pollard rho; n fits in 64 bits here)."""
    out: set[int] = set()
    stack = [n]
    while stack:
        m = stack.pop()
        if m == 1:
            continue
        if is_prime(m):
            out.add(m)
            continue
        d = _pollard_rho(m)
        stack.append(d)
        stack.append(m // d)
    return out


def _pollard_rho(n: int) -> int:
    if n % 2 == 0:
        return 2
    while True:
        x = random.randrange(2, n)
        y = x
        c = random.randrange(1, n)
        d = 1
        while d == 1:
            x = (x * x + c) % n
            y = (y * y + c) % n
            y = (y * y + c) % n
            d = _gcd(abs(x - y), n)
        if d != n:
            return d


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def mod_inverse(a: int, p: int) -> int:
    return pow(a, -1, p)
