"""Huffman coding: device-side histograms, host-side canonical table
construction, and the reference's per-block size-estimate semantics.

The reference builds a per-block Huffman tree over raw RLE values with a
min-heap (entropy.c:15-128, :261-328) and only ever *estimates* sizes
(get_encoded_size, entropy.c:363-399) — codes are never emitted as bits
(SURVEY.md B2). This module supplies what a real device codec needs instead:

  * per-image (per-plane) tables built from a GLOBAL symbol histogram —
    computed on device as a vectorized bincount and combined across shards
    with a psum (parallel/shard_encode.py), so every shard derives the
    identical table and the bitstream is mesh-shape-independent;
  * canonical code assignment (codes derivable from lengths alone, so the
    container serializes 16 bytes of lengths instead of a tree);
  * JPEG-style magnitude-category value coding (bounded 12-symbol alphabet +
    raw extra bits) as the default, with "direct" value coding as the mode
    closest to the reference's per-value alphabet;
  * an exact reimplementation of the reference's size-estimate accounting
    (Huffman total bits are tie-break-invariant, so an independent heap
    gives identical sums — including quirk B3: a single-symbol alphabet
    costs 0 bits/value).

Tree construction is inherently serial and tiny (alphabet <= 16 for category
mode); it runs on host in NumPy, fed by device histograms.
"""

from __future__ import annotations

import heapq

import jax
import jax.numpy as jnp
import numpy as np

MAX_CODE_LEN = 16  # canonical tables cap code length at 16 bits
NUM_CATEGORIES = 16  # categories 0..15; |value| < 2^15 always holds here
RUN_BITS = 8  # fixed-length run field, reference convention (entropy.c:390)
# Runs 0..n2: the positional RLE's terminal-zero symbol of an ALL-ZERO
# block carries run = n2 (64 zeros precede nothing; the decoder's pos+=run
# then simply ends the block), so the alphabet has 65 entries for 8x8.
RUN_ALPHABET = 65
# Coded-runs mode (cfg.coded_runs) Huffman-codes the run field instead of
# spending a flat 8 bits (~83% of runs are <= 3 on photographic content).
# Capping run codes at 8 bits keeps every worst-case shape (bits/symbol,
# units/block) identical to the fixed-run layout.
RUN_MAX_CODE_LEN = 8


# ---------------------------------------------------------------------------
# Magnitude categories (JPEG-style value coding)
# ---------------------------------------------------------------------------


def category_of(values: jax.Array) -> jax.Array:
    """Bits needed for |v|: cat(0) = 0, cat(v) = floor(log2|v|) + 1.

    Works on int32 arrays; uses float log2-free formulation via bit twiddling
    (31 - clz). Max relevant category is 11 (|coeff| <= 2047).
    """
    a = jnp.abs(values)
    # ceil(log2(a+1)) via count of significant bits.
    return (32 - jax.lax.clz(a.astype(jnp.int32))) * (a > 0)


def category_extra_bits(values: jax.Array, cats: jax.Array) -> jax.Array:
    """JPEG 'additional bits' for a value within its category.

    v > 0: the low ``cat`` bits of v. v < 0: low ``cat`` bits of
    ``v + 2^cat - 1`` (one's-complement style). Returned as uint32.
    """
    v = values.astype(jnp.int32)
    adj = jnp.where(v < 0, v + (1 << cats) - 1, v)
    mask = jnp.where(cats >= 32, jnp.int32(-1), (1 << cats) - 1)
    return (adj & mask).astype(jnp.uint32)


def value_from_category(cat: np.ndarray, extra: np.ndarray) -> np.ndarray:
    """Inverse of category coding (host-side decode)."""
    cat = np.asarray(cat, np.int64)
    extra = np.asarray(extra, np.int64)
    half = np.where(cat > 0, 1 << np.maximum(cat - 1, 0), 0)
    neg = (cat > 0) & (extra < half)
    val = np.where(neg, extra - (1 << cat) + 1, extra)
    return np.where(cat == 0, 0, val).astype(np.int32)


# ---------------------------------------------------------------------------
# Device histograms
# ---------------------------------------------------------------------------


def category_histogram_masked(values: jax.Array, live: jax.Array) -> jax.Array:
    """Histogram of symbol categories over live symbols (mask form).

    Compare-and-reduce over the 16 bins — no scatter: 16 fused
    elementwise reduction channels.
    Returns (NUM_CATEGORIES,) int32 — psum-able across shards.
    """
    cats = jnp.where(live, category_of(values), -1)
    bins = jnp.arange(NUM_CATEGORIES, dtype=jnp.int32)
    eq = cats[..., None] == bins  # (..., 16)
    return jnp.sum(eq, axis=tuple(range(eq.ndim - 1)), dtype=jnp.int32)


def category_histogram(values: jax.Array, counts: jax.Array) -> jax.Array:
    """Histogram of symbol categories over live RLE symbols.

    values: (B, S) int32; counts: (B,) live symbols per block.
    Returns (NUM_CATEGORIES,) int32 — psum-able across shards.
    """
    B, S = values.shape
    s_idx = jax.lax.broadcasted_iota(jnp.int32, (B, S), 1)
    return category_histogram_masked(values, s_idx < counts[:, None])


def value_histogram(
    values: jax.Array, counts: jax.Array, vmin: int, vmax: int
) -> jax.Array:
    """Histogram of raw symbol values over [vmin, vmax] (direct mode).

    Out-of-range values land in the final overflow bin (reserved ESC symbol).
    Returns (vmax - vmin + 2,) int32: alphabet bins + ESC.
    """
    B, S = values.shape
    n_bins = vmax - vmin + 1
    s_idx = jax.lax.broadcasted_iota(jnp.int32, (B, S), 1)
    live = s_idx < counts[:, None]
    shifted = values - vmin
    in_range = (shifted >= 0) & (shifted < n_bins)
    idx = jnp.where(live & in_range, shifted, jnp.where(live, n_bins, n_bins + 1))
    hist = jnp.zeros(n_bins + 2, jnp.int32).at[idx.ravel()].add(1)
    return hist[: n_bins + 1]  # [alphabet..., ESC]


# ---------------------------------------------------------------------------
# Host-side table construction (tiny + serial; deterministic)
# ---------------------------------------------------------------------------


def huffman_code_lengths(freqs: np.ndarray, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Optimal prefix-code lengths from symbol frequencies.

    Deterministic tie-breaking (heap keyed on (freq, creation order)); total
    weighted length equals any other valid Huffman coder's — the quantity
    the reference's get_encoded_size measures is tie-invariant.

    Symbols with zero frequency get length 0 (absent). A single-symbol
    alphabet gets length 1 (decodable; contrast reference quirk B3 which
    assigns the empty code). Lengths exceeding ``max_len`` are re-balanced
    with the JPEG adjust-bits procedure.
    """
    freqs = np.asarray(freqs, np.int64)
    n = len(freqs)
    present = np.nonzero(freqs > 0)[0]
    lengths = np.zeros(n, np.int32)
    if len(present) == 0:
        return lengths
    if len(present) == 1:
        lengths[present[0]] = 1
        return lengths

    # (freq, tiebreak, node) — node is a leaf symbol int or a merged tuple.
    heap = [(int(freqs[s]), i, int(s)) for i, s in enumerate(present)]
    heapq.heapify(heap)
    tiebreak = len(heap)
    while len(heap) > 1:
        f1, _, n1 = heapq.heappop(heap)
        f2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, tiebreak, (n1, n2)))
        tiebreak += 1

    def walk(node, depth):
        if isinstance(node, int):
            lengths[node] = max(depth, 1)
            return
        walk(node[0], depth + 1)
        walk(node[1], depth + 1)

    walk(heap[0][2], 0)

    if lengths.max() > max_len:
        lengths = _limit_lengths(lengths, freqs, max_len)
    return lengths


def _limit_lengths(lengths: np.ndarray, freqs: np.ndarray, max_len: int) -> np.ndarray:
    """JPEG Annex K.3-style adjust-bits: fold over-long codes under max_len.

    Operates on the count-per-length histogram; preserves Kraft equality and
    prefix-decodability, then reassigns lengths to symbols ordered by
    (frequency desc, symbol index asc)."""
    counts = np.bincount(lengths[lengths > 0], minlength=33)
    if len(counts) < 33:
        counts = np.pad(counts, (0, 33 - len(counts)))
    for ln in range(32, max_len, -1):
        while counts[ln] > 0:
            j = ln - 2
            while counts[j] == 0:
                j -= 1
            counts[ln] -= 2
            counts[ln - 1] += 1
            counts[j] -= 1
            counts[j + 1] += 2
    order = np.lexsort((np.arange(len(freqs)), -freqs))
    order = [s for s in order if freqs[s] > 0]
    out = np.zeros_like(lengths)
    it = iter(order)
    for ln in range(1, max_len + 1):
        for _ in range(int(counts[ln])):
            out[next(it)] = ln
    return out


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical Huffman codes (uint32) from lengths.

    Codes assigned in (length, symbol) order — the decoder rebuilds the
    identical table from lengths alone, which is all the container stores.
    """
    lengths = np.asarray(lengths, np.int32)
    codes = np.zeros(len(lengths), np.uint32)
    code = 0
    prev_len = 0
    for sym in np.lexsort((np.arange(len(lengths)), lengths)):
        ln = int(lengths[sym])
        if ln == 0:
            continue
        code <<= ln - prev_len
        codes[sym] = code
        code += 1
        prev_len = ln
    return codes


class CanonicalTable:
    """A canonical Huffman table: lengths + derived codes + decode index."""

    def __init__(self, lengths: np.ndarray):
        self.lengths = np.asarray(lengths, np.int32)
        # Wire-level validation (containers store raw u8 lengths): lengths
        # over 32 overflow code construction, and an over-subscribed Kraft
        # sum cannot be a prefix code — both mean a corrupt table.
        if np.any(self.lengths < 0) or np.any(self.lengths > 32):
            raise ValueError("invalid canonical code length (must be 0..32)")
        live = self.lengths[self.lengths > 0]
        # exact comparison: the ldexp terms sum exactly in float64 (minimum
        # over-subscription excess is 2^-32, far above f64 resolution here)
        if live.size and float(np.sum(np.ldexp(1.0, -live))) > 1.0:
            raise ValueError("over-subscribed canonical Huffman table")
        self.codes = canonical_codes(self.lengths)
        # Decode tables: symbols sorted by (length, symbol).
        order = [
            s for s in np.lexsort((np.arange(len(lengths)), self.lengths))
            if self.lengths[s] > 0
        ]
        self.sorted_symbols = np.asarray(order, np.int32)
        self.sorted_lengths = self.lengths[self.sorted_symbols]
        self.sorted_codes = self.codes[self.sorted_symbols]

    @classmethod
    def from_frequencies(cls, freqs: np.ndarray, max_len: int = MAX_CODE_LEN):
        return cls(huffman_code_lengths(freqs, max_len))

    def decode_one(self, bit_reader) -> int:
        """Decode a single symbol (host-side reference decoder)."""
        code = 0
        ln = 0
        i = 0
        n = len(self.sorted_symbols)
        while i < n:
            target = int(self.sorted_lengths[i])
            while ln < target:
                code = (code << 1) | bit_reader.read_bit()
                ln += 1
            while i < n and int(self.sorted_lengths[i]) == ln:
                if int(self.sorted_codes[i]) == code:
                    return int(self.sorted_symbols[i])
                i += 1
        raise ValueError("invalid Huffman code in stream")


# ---------------------------------------------------------------------------
# Static default table (single-pass mode)
# ---------------------------------------------------------------------------

# Quality-banded default tables. Round 1 shipped ONE table tuned on
# synthetic content at mixed qualities; real-image validation
# (benchmarks/real_validation.py over tests/data/, VERDICT.md weak #6)
# measured up to 18% size penalty vs per-image dynamic tables because the
# category/run statistics shift strongly with quality. Three bands, each
# tuned by multiplicative-weights MINIMAX over real rasters (photograph,
# MRI, DEM, topobathy) + synthetic photos at that band's qualities
# (benchmarks/retune_minimax.py): worst-case penalty per band drops
# 18.1->3.8%, 5.8->2.0%, 15.7->9.6%. The decoder reads code lengths from
# the container, so the choice of band is encode-side only — no wire
# compatibility constraint. Every entry is >= 1, so any symbol remains
# encodable regardless of content.
_BAND_EDGES = (25, 75)  # quality <= 25 | 26..75 | >= 76

_DEFAULT_CATEGORY_PSEUDO_FREQS_BANDS = (
    np.array([10177, 15833, 6507, 3670, 2753, 1060,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1], np.int64),
    np.array([5642, 16727, 7749, 4086, 2494, 1647, 1082, 574,
              1, 1, 1, 1, 1, 1, 1, 1], np.int64),
    np.array([1989, 9437, 7395, 11660, 4129, 1845, 1233, 858, 594, 463,
              397, 1, 1, 1, 1, 1], np.int64),
)

_DEFAULT_RUN_PSEUDO_FREQS_BANDS = (
    np.array([22524, 4396, 1256, 738, 376, 207, 134, 88, 49, 19, 23, 7, 3,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2,
              1, 1, 1, 2, 2, 19, 37, 10, 3, 2, 38, 44, 63, 84, 57, 9, 92,
              142, 190, 59, 43, 212, 386, 206, 91, 567, 753, 186, 2783,
              1016, 2970, 101], np.int64),
    np.array([25507, 4765, 1590, 891, 583, 362, 257, 137, 86, 49, 51, 25,
              18, 21, 7, 5, 3, 6, 6, 3, 4, 13, 11, 3, 8, 6, 2, 5, 3, 12,
              14, 27, 34, 25, 3, 9, 22, 26, 92, 144, 46, 38, 9, 130, 161,
              156, 97, 52, 13, 83, 148, 216, 110, 86, 303, 257, 121, 90,
              452, 916, 239, 456, 86, 896, 1], np.int64),
    np.array([26035, 5950, 2425, 1322, 802, 506, 331, 219, 154, 142, 139,
              72, 56, 42, 32, 25, 28, 34, 14, 26, 48, 55, 32, 17, 36, 37,
              13, 8, 22, 30, 64, 60, 84, 39, 21, 27, 72, 38, 116, 196, 85,
              84, 24, 139, 103, 61, 36, 19, 7, 18, 16, 13, 9, 5, 4, 2, 2,
              1, 1, 1, 1, 1, 1, 1, 1], np.int64),
)


def _band(quality: int) -> int:
    if quality <= _BAND_EDGES[0]:
        return 0
    if quality <= _BAND_EDGES[1]:
        return 1
    return 2


@np.errstate(all="ignore")
def default_category_table(quality: int = 50) -> "CanonicalTable":
    return CanonicalTable.from_frequencies(
        _DEFAULT_CATEGORY_PSEUDO_FREQS_BANDS[_band(quality)]
    )


def default_run_table(quality: int = 50) -> "CanonicalTable":
    return CanonicalTable.from_frequencies(
        _DEFAULT_RUN_PSEUDO_FREQS_BANDS[_band(quality)],
        max_len=RUN_MAX_CODE_LEN,
    )


def run_histogram_masked(runs: jax.Array, live: jax.Array) -> jax.Array:
    """Histogram of run lengths over live symbols, (RUN_ALPHABET,) int32 —
    psum-able across shards (coded-runs mode table construction)."""
    r = jnp.where(live, runs, -1)
    bins = jnp.arange(RUN_ALPHABET, dtype=jnp.int32)
    eq = r[..., None] == bins
    return jnp.sum(eq, axis=tuple(range(eq.ndim - 1)), dtype=jnp.int32)


# ---------------------------------------------------------------------------
# Reference size-estimate semantics (parity with get_encoded_size)
# ---------------------------------------------------------------------------


def reference_encoded_size_bits(
    values: np.ndarray, use_huffman: bool = True
) -> int:
    """Bit-size estimate with the reference's exact accounting
    (entropy.c:363-399):

      * Huffman mode: per-BLOCK Huffman over raw values; total =
        sum(freq * code_len) + 8 bits per symbol for the run. A
        single-symbol alphabet costs 0 bits per value (quirk B3: the root
        leaf gets the empty code).
      * non-Huffman: 24 bits per symbol (16 value + 8 run).

    Huffman totals are tie-invariant, so this matches the C heap bit-for-bit
    (asserted against the oracle in tests/test_entropy_stage.py).
    """
    values = np.asarray(values)
    count = len(values)
    if not use_huffman:
        return int(count * 24)
    if count == 0:
        return 0
    uniq, freqs = np.unique(values, return_counts=True)
    if len(uniq) == 1:
        return int(count * RUN_BITS)  # empty code for the lone symbol (B3)
    # Plain Huffman, no length cap (reference has none; depth < 32 in practice).
    lengths = huffman_code_lengths(freqs, max_len=32)
    return int((freqs * lengths).sum() + count * RUN_BITS)
