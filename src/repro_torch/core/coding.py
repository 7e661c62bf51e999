"""Entropy-coded wire codec (v2): the coder subsystem behind
``wire.WireFormat(codec="v2")``.

The v1 wire format ships fixed-width fields, and ``tests/test_wire.py``
historically *documented* the gap to the paper's bit-budget analysis —
K⌈log2 V⌉ for a support set the paper charges log2 C(V,K) for, and
K⌈log2(ℓ+1)⌉ for lattice counts whose composition code costs
log2 C(ℓ−1, K−1).  This module closes that gap with real, deterministic,
byte-exact codes:

  * ``RangeEncoder`` / ``RangeDecoder`` — a byte-oriented binary-carry
    range coder (LZMA style: 32-bit range, 33-bit low with an explicit
    carry propagated through a cache + pending-0xFF run).  Arbitrary
    integer frequency totals up to 2^16, single forward pass on BOTH
    sides, so adaptive models update symbol-by-symbol in lockstep with
    the decoder.  Renormalisation is byte-granular; the byte stream is
    embedded in the payload's bit stream, and the decoder consumes
    exactly the bytes the encoder emitted (no length prefix needed).

  * ``UniformModel`` / ``AdaptiveModel`` — integer frequency models.
    The adaptive model starts from all-ones counts and applies the same
    increment/rescale schedule on encode and decode, so the two ends
    rebuild identical tables (pinned by tests/test_coding.py).

  * ``subset_rank`` / ``subset_unrank`` — enumerative (combinatorial
    number system) coding of a sorted K-subset of [V]: the rank in
    [0, C(V,K)) is written in exactly ``(C(V,K)−1).bit_length()`` bits,
    i.e. within one bit of the paper's log2 C(V,K) charge.

  * ``rice_encode`` / ``rice_decode`` — Golomb-Rice coding of the
    sparse lattice counts b (b_i ≥ 1, Σb = ℓ): the K−1 first excesses
    b_i − 1 are Rice-coded with a parameter derived deterministically
    from (ℓ, K) (the mean excess is known a priori), the last count is
    elided (the sum pins it), and an escape (RICE_ESCAPE ones) bounds
    the unary part for adversarial skew.

  * a compact verdict coder — accept-prefix lengths are geometric-ish
    and skew toward full acceptance, so the downlink codes
    L_max − T with a short Rice code instead of a fixed-width field.

Both payload codecs carry a 1-bit mode flag: 0 = entropy-coded body,
1 = the exact v1 fixed-width body.  The packer encodes both and keeps
the shorter, so a v2 payload is never more than one bit (≤ one byte
after padding) longer than v1 — and on any payload the coded path can
represent (sorted support, counts ≥ 1 summing to ℓ) it is shorter in
practice.  β values stay raw float32 bit patterns: they are PRNG-driven
side information the codec treats as incompressible.

Everything here is host-side integer/numpy arithmetic — deterministic
across platforms, no floating point anywhere near a codeword.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.wire import (BitReader, BitWriter, DraftPayload,
                             VerdictPayload, WireDecodeError, field_width)

MASK32 = (1 << 32) - 1
RANGE_TOP = 1 << 24          # renormalise while range < RANGE_TOP
MAX_TOTAL = 1 << 16          # frequency totals must stay below range/top
RICE_ESCAPE = 15             # unary quotients >= this escape to raw


# ======================================================================
# Range coder (byte-oriented, carry-exact, forward on both sides)
# ======================================================================
class RangeEncoder:
    """LZMA-style range encoder writing its bytes into a BitWriter.

    The leading cache byte is provably 0 (low starts at 0 and the first
    carry cannot precede the first emission), so it is suppressed; the
    decoder primes its 32-bit code register from 4 bytes.  Flush emits
    5 shifts, so the total bytes on the wire are (renormalisations + 4)
    — exactly what the decoder consumes, which is what lets the bit
    stream continue immediately after the coded block.
    """

    def __init__(self, w: BitWriter):
        self._w = w
        self.low = 0                  # 33 bits during carry
        self.rng = MASK32
        self._cache = 0
        self._cache_size = 1
        self._lead = True             # suppress the provably-zero lead

    def _out(self, byte: int):
        if self._lead:
            assert byte == 0, "range coder leading byte must be 0"
            self._lead = False
            return
        self._w.write([byte & 0xFF], 8)

    def _shift_low(self):
        if self.low < 0xFF000000 or self.low > MASK32:
            carry = self.low >> 32
            self._out((self._cache + carry) & 0xFF)
            while self._cache_size > 1:
                self._out((0xFF + carry) & 0xFF)
                self._cache_size -= 1
            self._cache = (self.low >> 24) & 0xFF
            self._cache_size = 0
        self._cache_size += 1
        self.low = (self.low << 8) & MASK32

    def encode(self, cum: int, freq: int, total: int):
        assert 0 < freq and 0 <= cum and cum + freq <= total <= MAX_TOTAL
        r = self.rng // total
        self.low += r * cum           # may set bit 32: the carry
        self.rng = r * freq
        while self.rng < RANGE_TOP:
            self.rng = (self.rng << 8) & MASK32
            self._shift_low()

    def encode_symbol(self, model, symbol: int):
        cum, freq, total = model.lookup(symbol)
        self.encode(cum, freq, total)
        model.update(symbol)

    def flush(self):
        for _ in range(5):
            self._shift_low()


class RangeDecoder:
    """Mirror of RangeEncoder, pulling bytes from a BitReader."""

    def __init__(self, r: BitReader):
        self._r = r
        self.rng = MASK32
        self.code = 0
        for _ in range(4):            # lead byte suppressed on encode
            self.code = (self.code << 8) | self._in()

    def _in(self) -> int:
        return int(self._r.read(8)[0])

    def decode_symbol(self, model) -> int:
        total = model.total
        r = self.rng // total
        c = min(self.code // r, total - 1)
        symbol = model.find(c)
        cum, freq, _ = model.lookup(symbol)
        self.code -= r * cum
        self.rng = r * freq
        while self.rng < RANGE_TOP:
            self.rng = (self.rng << 8) & MASK32
            self.code = ((self.code << 8) | self._in()) & MASK32
        model.update(symbol)
        return symbol


# ======================================================================
# Frequency models (identical evolution on both ends)
# ======================================================================
class UniformModel:
    """Static model: every symbol of an alphabet of n has frequency 1,
    costing exactly log2 n (fractional) bits per symbol — the coded
    replacement for a ⌈log2 n⌉ fixed-width field."""

    def __init__(self, n: int):
        assert 1 <= n <= MAX_TOTAL
        self.total = n

    def lookup(self, s: int) -> Tuple[int, int, int]:
        assert 0 <= s < self.total
        return s, 1, self.total

    def find(self, c: int) -> int:
        return int(c)

    def update(self, s: int):
        pass


class AdaptiveModel:
    """Frequency-counting model: counts start at 1, the observed symbol
    gains ``inc`` after each lookup, and counts are halved (floored at
    1) when the total exceeds ``limit``.  Encoder and decoder apply the
    exact same schedule, so their tables are identical after every
    symbol — the determinism the property tests pin."""

    # largest alphabet the rescale schedule supports: limit = 2n and
    # limit + inc must stay under the coder's MAX_TOTAL
    MAX_ALPHABET = 1 << 14

    def __init__(self, n: int, inc: int = 24, limit: int = 1 << 13):
        assert 1 <= n <= self.MAX_ALPHABET
        self.n = n
        self.inc = inc
        self.limit = max(limit, 2 * n)
        assert self.limit + inc <= MAX_TOTAL
        self.freq = np.ones(n, np.int64)
        self.total = n

    def lookup(self, s: int) -> Tuple[int, int, int]:
        assert 0 <= s < self.n
        return int(self.freq[:s].sum()), int(self.freq[s]), self.total

    def find(self, c: int) -> int:
        cum = np.cumsum(self.freq)
        return int(np.searchsorted(cum, c, side="right"))

    def update(self, s: int):
        self.freq[s] += self.inc
        self.total += self.inc
        if self.total > self.limit:
            self.freq = (self.freq + 1) // 2
            self.total = int(self.freq.sum())


# ======================================================================
# Enumerative subset coding (combinatorial number system)
# ======================================================================
def subset_rank_width(V: int, K: int) -> int:
    """Exact bits the coded support field occupies: the rank lives in
    [0, C(V,K)), so (C−1).bit_length() — within 1 bit of log2 C(V,K)."""
    return (math.comb(V, K) - 1).bit_length()


def subset_rank(indices) -> int:
    """Rank of a sorted strictly-increasing subset: Σ_j C(c_j, j+1)."""
    r = 0
    for j, c in enumerate(indices):
        r += math.comb(c, j + 1)
    return r


def subset_unrank(rank: int, V: int, K: int) -> Tuple[int, ...]:
    """Inverse of subset_rank for K-subsets of [0, V)."""
    out = []
    for j in range(K, 0, -1):
        lo, hi = j - 1, V - 1
        while lo < hi:                      # largest c with C(c,j) <= rank
            mid = (lo + hi + 1) // 2
            if math.comb(mid, j) <= rank:
                lo = mid
            else:
                hi = mid - 1
        out.append(lo)
        rank -= math.comb(lo, j)
    assert rank == 0, "subset rank out of range"
    return tuple(reversed(out))


def write_big(w: BitWriter, value: int, nbits: int):
    """MSB-first arbitrary-precision field (ranks exceed 64 bits)."""
    assert value >= 0 and value < (1 << nbits) if nbits else value == 0
    off = nbits
    while off > 0:
        take = min(32, off)
        off -= take
        w.write([(value >> off) & ((1 << take) - 1)], take)


def read_big(r: BitReader, nbits: int) -> int:
    v = 0
    off = nbits
    while off > 0:
        take = min(32, off)
        off -= take
        v = (v << take) | int(r.read(take)[0])
    return v


# ======================================================================
# Golomb-Rice coding of the lattice counts
# ======================================================================
def rice_param(ell: int, K: int) -> int:
    """Deterministic Rice parameter for the excesses b_i − 1 of K
    positive counts summing to ℓ: the mean excess (ℓ−K)/K is known to
    both ends before any count is read."""
    if K <= 1:
        return 0
    mean = max(1, (ell - K) // K)
    return max(0, mean.bit_length() - 1)


def rice_encode(w: BitWriter, value: int, k: int, vmax: int):
    q = value >> k
    if q >= RICE_ESCAPE:                   # escape: RICE_ESCAPE ones + raw
        w.write([(1 << RICE_ESCAPE) - 1], RICE_ESCAPE)
        w.write([value], field_width(vmax))
        return
    w.write([((1 << q) - 1) << 1], q + 1)  # q ones, then a 0
    if k:
        w.write([value & ((1 << k) - 1)], k)


def rice_decode(r: BitReader, k: int, vmax: int) -> int:
    q = 0
    while q < RICE_ESCAPE and int(r.read(1)[0]) == 1:
        q += 1
    if q >= RICE_ESCAPE:
        return int(r.read(field_width(vmax))[0])
    low = int(r.read(k)[0]) if k else 0
    return (q << k) | low


def rice_bits(value: int, k: int, vmax: int) -> int:
    """Actual bits rice_encode spends on one value."""
    q = value >> k
    if q >= RICE_ESCAPE:
        return RICE_ESCAPE + field_width(vmax)
    return q + 1 + k


def rice_counts_bits(counts, ell: int) -> int:
    """Actual bits the v2 count field spends on one position (the last
    count rides for free — the sum ℓ pins it)."""
    K = len(counts)
    k = rice_param(ell, K)
    return sum(rice_bits(c - 1, k, ell - 1) for c in counts[:-1])


def verdict_rice_k(L_max: int) -> int:
    return max(0, field_width(L_max) - 3)


# ======================================================================
# Draft payload codec v2
# ======================================================================
def _coded_draft_ok(fmt, p: DraftPayload) -> bool:
    """Can the entropy-coded path represent this payload?  (Sorted
    strict support, counts ≥ 1 summing to ℓ — what build_draft_payload
    produces.)  Anything else takes the v1-body fallback."""
    if fmt.mode != "lattice" or p.n_drafts > fmt.L_max:
        return False
    if len(p.betas) != p.n_drafts + 1:
        return False
    Ka = min(fmt.V, fmt.ell)
    if Ka > AdaptiveModel.MAX_ALPHABET:      # K model can't cover it
        return False
    for tok in p.tokens:
        if not 0 <= tok < fmt.V:
            return False
    for sup, cnt in zip(p.supports, p.counts):
        K = len(sup)
        if K != len(cnt) or not 1 <= K <= Ka:
            return False
        if any(c < 1 or c > fmt.ell for c in cnt) or sum(cnt) != fmt.ell:
            return False
        if list(sup) != sorted(set(sup)) or sup[-1] >= fmt.V or sup[0] < 0:
            return False
    return True


def _encode_draft(fmt, p: DraftPayload) -> Optional[BitWriter]:
    if not _coded_draft_ok(fmt, p):
        return None
    w = BitWriter()
    n = p.n_drafts
    w.write([n], fmt.n_field)
    Ka = min(fmt.V, fmt.ell)
    small_V = fmt.V <= MAX_TOTAL
    if n:
        enc = RangeEncoder(w)
        if small_V:
            uni = UniformModel(fmt.V)
            for tok in p.tokens:
                enc.encode_symbol(uni, tok)
        kmodel = AdaptiveModel(Ka)
        for sup in p.supports:
            enc.encode_symbol(kmodel, len(sup) - 1)
        enc.flush()
    if not small_V:
        w.write(list(p.tokens), fmt.tok_field)
    for sup in p.supports:
        K = len(sup)
        if K < fmt.V:
            nb = subset_rank_width(fmt.V, K)
            if nb:
                write_big(w, subset_rank(sup), nb)
    for cnt in p.counts:
        k = rice_param(fmt.ell, len(cnt))
        for c in cnt[:-1]:
            rice_encode(w, c - 1, k, fmt.ell - 1)
    w.write_f32(list(p.betas))
    return w


def _decode_draft(fmt, r: BitReader) -> DraftPayload:
    n = int(r.read(fmt.n_field)[0])
    if n > fmt.L_max:
        raise WireDecodeError(f"draft count {n} exceeds L_max={fmt.L_max}")
    Ka = min(fmt.V, fmt.ell)
    small_V = fmt.V <= MAX_TOTAL
    tokens, Ks = [], []
    if n:
        dec = RangeDecoder(r)
        if small_V:
            uni = UniformModel(fmt.V)
            tokens = [dec.decode_symbol(uni) for _ in range(n)]
        kmodel = AdaptiveModel(Ka)
        Ks = [dec.decode_symbol(kmodel) + 1 for _ in range(n)]
    if not small_V:
        tokens = [int(t) for t in r.read(fmt.tok_field, n)]
    supports = []
    for K in Ks:
        if K < fmt.V:
            nb = subset_rank_width(fmt.V, K)
            rank = read_big(r, nb) if nb else 0
            supports.append(subset_unrank(rank, fmt.V, K))
        else:
            supports.append(tuple(range(fmt.V)))
    counts = []
    for K in Ks:
        k = rice_param(fmt.ell, K)
        cnt = [rice_decode(r, k, fmt.ell - 1) + 1 for _ in range(K - 1)]
        last = fmt.ell - sum(cnt)
        if last < 1:
            raise WireDecodeError(
                "lattice counts exceed ℓ: corrupt coded draft body")
        cnt.append(last)
        counts.append(tuple(cnt))
    betas = tuple(float(b) for b in r.read_f32(n + 1))
    return DraftPayload(tokens=tuple(tokens), supports=tuple(supports),
                        counts=tuple(counts), betas=betas)


def _choose_body(coded: Optional[BitWriter],
                 v1: BitWriter) -> Tuple[int, BitWriter]:
    """The ONE selection rule behind every v2 pack and every coded_*
    size report: flag 0 + coded body when it is strictly shorter,
    flag 1 + the exact v1 body otherwise.  A v2 payload is therefore
    never more than ONE BIT (one byte after padding) longer than v1 —
    and on small-vocabulary (smoke) lattice payloads the coded body
    wins by enough that v2 never exceeds v1 in bytes."""
    if coded is not None and coded.n_bits < v1.n_bits:
        return 0, coded
    return 1, v1


def _flagged(flag: int, body: BitWriter) -> bytes:
    w = BitWriter()
    w.write([flag], 1)
    w.extend(body)
    return w.getvalue()


def pack_draft_v2(fmt, p: DraftPayload) -> bytes:
    v1 = BitWriter()
    fmt.write_draft_body(v1, p)
    return _flagged(*_choose_body(_encode_draft(fmt, p), v1))


def unpack_draft_v2(fmt, data: bytes) -> DraftPayload:
    r = BitReader(data)
    if int(r.read(1)[0]):
        return fmt.read_draft_body(r)
    return _decode_draft(fmt, r)


def coded_draft_bits(fmt, p: DraftPayload) -> int:
    """Actual bits of the v2 payload (before byte padding) — computed
    by the same selection rule pack_draft_v2 applies."""
    v1 = BitWriter()
    fmt.write_draft_body(v1, p)
    _, body = _choose_body(_encode_draft(fmt, p), v1)
    return 1 + body.n_bits


# ======================================================================
# Verdict codec v2
# ======================================================================
def _encode_verdict(fmt, v: VerdictPayload) -> Optional[BitWriter]:
    if not (0 <= v.n_accept <= fmt.L_max and 0 <= v.new_token < fmt.V):
        return None
    w = BitWriter()
    rice_encode(w, fmt.L_max - v.n_accept, verdict_rice_k(fmt.L_max),
                fmt.L_max)
    w.write([v.new_token], fmt.tok_field)
    w.write_f32([v.beta_next])
    return w


def pack_verdict_v2(fmt, v: VerdictPayload) -> bytes:
    v1 = BitWriter()
    fmt.write_verdict_body(v1, v)
    return _flagged(*_choose_body(_encode_verdict(fmt, v), v1))


def unpack_verdict_v2(fmt, data: bytes) -> VerdictPayload:
    r = BitReader(data)
    if int(r.read(1)[0]):
        return fmt.read_verdict_body(r)
    T = fmt.L_max - rice_decode(r, verdict_rice_k(fmt.L_max), fmt.L_max)
    if T < 0:
        raise WireDecodeError(
            "accept-length residue exceeds L_max: corrupt verdict body")
    return VerdictPayload(
        n_accept=T,
        new_token=int(r.read(fmt.tok_field)[0]),
        beta_next=float(r.read_f32(1)[0]))


def coded_verdict_bits(fmt, v: VerdictPayload) -> int:
    v1 = BitWriter()
    fmt.write_verdict_body(v1, v)
    _, body = _choose_body(_encode_verdict(fmt, v), v1)
    return 1 + body.n_bits


# ======================================================================
# Verdict BATCH codec v2 (one coded downlink frame per cell)
# ======================================================================
def _encode_verdict_batch(fmt, items, n_slots: int) -> Optional[BitWriter]:
    """Coded frame body: count + slot ids fixed-width, then ONE
    range-coded run over the accept-length residues L_max − T (an
    adaptive model shared by every verdict in the frame — the batch
    analogue of the per-message Rice code, amortising the model's
    learning the way the frame amortises framing), new tokens under a
    uniform model, β values raw f32 (incompressible side info)."""
    for s, v in items:
        if not (0 <= v.n_accept <= fmt.L_max and 0 <= v.new_token < fmt.V):
            return None
    if fmt.V > MAX_TOTAL:        # token alphabet exceeds the coder
        return None
    w = BitWriter()
    w.write([len(items)], 8)
    sf = fmt.slot_field(n_slots)
    w.write([s for s, _ in items], sf)
    enc = RangeEncoder(w)
    resid_model = AdaptiveModel(fmt.L_max + 1)
    tok_model = UniformModel(fmt.V)
    for _, v in items:
        enc.encode_symbol(resid_model, fmt.L_max - v.n_accept)
    for _, v in items:
        enc.encode_symbol(tok_model, v.new_token)
    enc.flush()
    w.write_f32([v.beta_next for _, v in items])
    return w


def _decode_verdict_batch(fmt, r: BitReader, n_slots: int):
    m = int(r.read(8)[0])
    if not 1 <= m <= fmt.MAX_BATCH_VERDICTS:
        raise WireDecodeError(f"verdict frame count {m} out of range")
    sf = fmt.slot_field(n_slots)
    slots = [int(s) for s in r.read(sf, m)]
    if slots != sorted(set(slots)) or slots[-1] >= n_slots:
        raise WireDecodeError(
            f"verdict frame slots not ascending unique in-range: "
            f"{slots} (n_slots={n_slots})")
    dec = RangeDecoder(r)
    resid_model = AdaptiveModel(fmt.L_max + 1)
    tok_model = UniformModel(fmt.V)
    Ts = [fmt.L_max - dec.decode_symbol(resid_model) for _ in range(m)]
    toks = [dec.decode_symbol(tok_model) for _ in range(m)]
    betas = [float(b) for b in r.read_f32(m)]
    return [(s, VerdictPayload(n_accept=T, new_token=t, beta_next=b))
            for s, T, t, b in zip(slots, Ts, toks, betas)]


def pack_verdict_batch_v2(fmt, items, n_slots: int) -> bytes:
    v1 = BitWriter()
    fmt.write_verdict_batch_body(v1, items, n_slots)
    return _flagged(*_choose_body(_encode_verdict_batch(fmt, items,
                                                        n_slots), v1))


def unpack_verdict_batch_v2(fmt, data: bytes, n_slots: int):
    r = BitReader(data)
    if int(r.read(1)[0]):
        return fmt.read_verdict_batch_body(r, n_slots)
    return _decode_verdict_batch(fmt, r, n_slots)


def coded_verdict_batch_bits(fmt, items, n_slots: int) -> int:
    """Actual bits of the v2 frame (before byte padding), by the same
    selection rule pack_verdict_batch_v2 applies."""
    v1 = BitWriter()
    fmt.write_verdict_batch_body(v1, items, n_slots)
    _, body = _choose_body(_encode_verdict_batch(fmt, items, n_slots), v1)
    return 1 + body.n_bits
