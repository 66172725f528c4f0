"""Private embedding lookup (PIR) under CKKS.

The port's copy of ``fhe_gpt2_tpu/net/pir.py``, on the port's LT engine
(``nn/linear.py``); the plans, and so the answers, are the JAX package's.
Two constructions mirroring the reference's PIR surface:

* EmbeddingPIRServer — the simple single-query homomorphic dot: a one-hot
  selector over the vocabulary contracted against the embedding table as one
  BSGS slot-linear transform.

* BatchPIRServer / BatchPIRClient — the vectorized BatchPIR counterpart
  (network/header/batchpirserver.h, vendored from mhmughees/vectorized_batchpir:
  BFV + 3-hash cuckoo bucketing + query packing), rebuilt in this framework's
  idiom: every vocabulary entry is replicated into its w=3 candidate buckets,
  the client cuckoo-assigns its token batch so each query lands in its own
  bucket, all per-bucket one-hot selectors pack into ONE strided query
  ciphertext, and the server answers the whole batch with a single BSGS LT
  (per-bucket sub-database contraction). One round, one query ct per
  ceil(buckets·stride/slots), answers packed per bucket.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..nn.linear import apply_lt, lt_from_triples


class EmbeddingPIRServer:
    """Holds the public embedding table; answers encrypted one-hot queries."""

    def __init__(self, table: np.ndarray, slots: int, giant=None):
        self.table = np.asarray(table, dtype=np.float64)   # [V, d]
        V, d = self.table.shape
        self.slots = slots
        n_src = -(-V // slots)
        if d > slots:
            raise ValueError(f"row width {d} exceeds {slots} slots")
        v_idx = np.repeat(np.arange(V), d)
        c_idx = np.tile(np.arange(d), V)
        spec = lt_from_triples(
            slots, n_src, 1,
            np.zeros_like(c_idx), c_idx,
            v_idx // slots, v_idx % slots,
            self.table[v_idx, c_idx], name="pir")
        self.plan = spec.bsgs_plan(giant)

    def required_steps(self):
        steps = set(a for a in self.plan.baby_amounts if a)
        steps |= {jg for jg in self.plan.groups if jg}
        return sorted(steps)

    def answer(self, B, query_cts: list):
        """query_cts: one-hot selector packed over ceil(V/slots) cts.
        Returns one ct with the embedding row in slots [0, d)."""
        [out] = apply_lt(B, self.plan, query_cts)
        return out


def make_query(token_id: int, vocab: int, slots: int) -> np.ndarray:
    """Client-side one-hot selector, host format [n_cts, slots]."""
    n = -(-vocab // slots)
    q = np.zeros((n, slots))
    q[token_id // slots, token_id % slots] = 1.0
    return q


# ---------------------------------------------------------------------------
# Vectorized BatchPIR (cuckoo-hashed buckets + packed queries)
# ---------------------------------------------------------------------------

def _p2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def _bucket_hash(v: int, i: int, m: int) -> int:
    """Deterministic public hash h_i(v) in [0, m) (blake2b; both parties
    derive the identical bucket structure)."""
    h = hashlib.blake2b(f"{i}:{v}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % m


class _BucketLayout:
    """Shared (public) bucket structure: entry v appears in its w candidate
    buckets; per-bucket sub-databases are ordered lists."""

    def __init__(self, vocab: int, batch_size: int, n_hash: int = 3,
                 expansion: float = 1.5):
        self.vocab = vocab
        self.n_hash = n_hash
        self.m = max(1, int(round(batch_size * expansion)))
        self.buckets = [[] for _ in range(self.m)]
        for v in range(vocab):
            seen = set()
            for i in range(n_hash):
                b = _bucket_hash(v, i, self.m)
                if b not in seen:       # hash collisions within one entry
                    seen.add(b)
                    self.buckets[b].append(v)
        self.cap = _p2(max(len(b) for b in self.buckets))

    def position(self, bucket: int, v: int) -> int:
        return self.buckets[bucket].index(v)


class BatchPIRServer:
    """Answers a whole batch of private lookups with one BSGS LT.

    Layout: bucket b occupies slot range [b·st, (b+1)·st) in both the query
    (one-hot at the entry's in-bucket position) and the answer (the d-dim
    embedding row); st = max(bucket capacity, d) rounded to a power of two,
    so every (position j → column c) edge has a bucket-independent rotation
    amount j − c, keeping the LT few-diagonal."""

    def __init__(self, table: np.ndarray, slots: int, batch_size: int,
                 n_hash: int = 3, expansion: float = 1.5, giant=None):
        self.table = np.asarray(table, dtype=np.float64)
        V, d = self.table.shape
        self.layout = _BucketLayout(V, batch_size, n_hash, expansion)
        lay = self.layout
        self.st = st = max(lay.cap, _p2(d))
        self.bpc = bpc = max(1, slots // st)           # buckets per ct
        self.n_cts = -(-lay.m // bpc)
        self.d = d
        dst_ct, dst_sl, src_ct, src_sl, w = [], [], [], [], []
        for b, entries in enumerate(lay.buckets):
            ct, off = divmod(b, bpc)
            for j, v in enumerate(entries):
                for c in range(d):
                    dst_ct.append(ct)
                    dst_sl.append(off * st + c)
                    src_ct.append(ct)
                    src_sl.append(off * st + j)
                    w.append(self.table[v, c])
        spec = lt_from_triples(
            slots, self.n_cts, self.n_cts,
            np.array(dst_ct), np.array(dst_sl),
            np.array(src_ct), np.array(src_sl),
            np.array(w), name="batchpir")
        self.plan = spec.bsgs_plan(giant)

    def required_steps(self):
        steps = set(a for a in self.plan.baby_amounts if a)
        steps |= {jg for jg in self.plan.groups if jg}
        return sorted(steps)

    def answer(self, B, query_cts: list) -> list:
        return apply_lt(B, self.plan, query_cts)


class BatchPIRClient:
    """Cuckoo-assigns a token batch to buckets and packs the queries."""

    def __init__(self, vocab: int, slots: int, batch_size: int, d: int,
                 n_hash: int = 3, expansion: float = 1.5, seed: int = 0):
        self.layout = _BucketLayout(vocab, batch_size, n_hash, expansion)
        self.slots = slots
        self.d = d
        self.st = max(self.layout.cap, _p2(d))
        self.bpc = max(1, slots // self.st)
        self.n_cts = -(-self.layout.m // self.bpc)
        self.rng = np.random.default_rng(seed)

    def assign(self, token_ids) -> dict:
        """Cuckoo insertion (random-walk eviction): token -> its own bucket."""
        lay = self.layout
        slot_of: dict = {}      # bucket -> token
        for t in token_ids:
            cur, tries = int(t), 0
            while True:
                cands = [_bucket_hash(cur, i, lay.m)
                         for i in range(lay.n_hash)]
                free = [b for b in cands if b not in slot_of]
                if free:
                    slot_of[free[0]] = cur
                    break
                tries += 1
                if tries >= 64 * len(token_ids):
                    raise RuntimeError("cuckoo insertion failed")
                b = cands[int(self.rng.integers(len(cands)))]
                cur, slot_of[b] = slot_of[b], cur
        return {tok: b for b, tok in slot_of.items()}

    def make_queries(self, token_ids):
        """(query [n_cts, slots] host one-hots, assignment token->bucket)."""
        asg = self.assign(token_ids)
        q = np.zeros((self.n_cts, self.slots))
        for tok, b in asg.items():
            j = self.layout.position(b, tok)
            ct, off = divmod(b, self.bpc)
            q[ct, off * self.st + j] = 1.0
        return q, asg

    def extract(self, answers: np.ndarray, assignment: dict,
                token_ids) -> np.ndarray:
        """answers: decrypted [n_cts, slots] -> [batch, d] embedding rows in
        token order."""
        out = np.zeros((len(token_ids), self.d))
        for k, tok in enumerate(token_ids):
            b = assignment[int(tok)]
            ct, off = divmod(b, self.bpc)
            out[k] = answers[ct, off * self.st: off * self.st + self.d]
        return out
