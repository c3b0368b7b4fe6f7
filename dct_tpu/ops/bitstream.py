"""Scan-based bitstream packing: RLE symbols -> real serialized bits.

The reference builds Huffman codes but never emits a bitstream — its decoder
reads the in-memory symbol array (entropy.c:333-358) and sizes are estimates
only (SURVEY.md B2). This module is the real thing, built data-parallel
(SURVEY.md section 7, hard part #1): variable-length output on a fixed-shape
machine via a two-pass scheme —

  pass 1: per-symbol bit lengths (vectorized gathers from the code-length
          table) and an exclusive prefix-sum of bit offsets per stripe;
  pass 2: each symbol's payload is split into <=16-bit chunks, every chunk
          lands in at most two 16-bit stream units, and all chunks are
          scatter-added into a zeroed unit buffer (bit ranges are disjoint
          by construction, so add == or, and no carries can occur).

Symbol wire format (MSB-first), per RLE symbol:
  category mode: huff(category) | extra bits (category count) | run (8b)
  direct mode:   huff(value)    | [ESC: raw 16b value]        | run (8b)
  none mode:     raw 16b value  |                             | run (8b)

The 8-bit fixed run field follows the reference's accounting convention
(entropy.c:390). After a block's symbols, the decoder's position invariant
(pos lands exactly at N^2 — see ops/rle.py) delimits blocks with no count
field. Stripes are byte-aligned independent substreams so multi-shard
encodes concatenate deterministically (SURVEY.md section 5.8).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dct_tpu.ops import huffman as hf
from dct_tpu.ops.rle import RLEBlocks, RLEPositional

# Static worst case per block: n^2 symbols x (16 huff + 15 extra + 8 run).
MAX_BITS_PER_SYMBOL = 16 + 15 + 8


def run_field_bits(n2: int) -> int:
    """Fixed run-field width for n2-coefficient blocks.

    The reference convention is a flat 8-bit run (entropy.c:390), which
    holds every run for N <= 15 (runs reach n2 for the all-zero block's
    terminal symbol — ops/rle.py). 16x16 blocks produce run 256, which
    silently truncated to 0 in round 1 and emitted an UNDECODABLE stream
    for any all-zero block; the field widens to bit_length(n2) there. The
    width is a pure function of block_size, which the container stores, so
    the format stays self-describing."""
    return max(8, int(n2).bit_length())


def units_per_block_worst(n2: int = 64, coded_runs: bool = False) -> int:
    """Worst-case 16-bit stream units one n2-coefficient block can emit.

    Round-1 hardcoded the 64-symbol (8x8) figure everywhere, which
    under-allocates the pack buffer for 16x16 blocks (256 symbols) under
    adversarial content; capacity must scale with the block size.

    Per-symbol ceiling: 16-bit code + 16-bit payload (direct-mode ESC raw;
    covers category's 15 extra bits too) + the run field — fixed
    run_field_bits(n2), or up to a 16-bit canonical run code under
    coded_runs (a caller-supplied run table may assign ANY run a
    max-length code, so capacity cannot assume the tuned tables)."""
    bits = 16 + 16 + (16 if coded_runs else run_field_bits(n2))
    return (n2 * bits + 15) // 16


UNITS_PER_BLOCK_WORST = units_per_block_worst(64)  # 160 (8x8 blocks)


class PackedStripes(NamedTuple):
    """units: (n_stripes, U) uint16 big-endian stream units (built in
    32-bit words and narrowed on the way out, halving device-memory and
    D2H bytes); bit_lengths: (n_stripes,) int32 actual payload bits."""

    units: jax.Array
    bit_lengths: jax.Array


def trim_units_count(bits: np.ndarray, capacity: int) -> int:
    """Unit count to keep when fetching a worst-case units buffer whose
    payload sizes are `bits`: the used maximum, rounded up to 1024 units to
    bound the number of distinct slice shapes XLA must compile."""
    max_units = int((int(bits.max()) + 15) // 16) if bits.size else 1
    return min(int(capacity), -(-max(max_units, 1) // 1024) * 1024)


def fetch_packed(packed: PackedStripes) -> PackedStripes:
    """Device PackedStripes -> host numpy, fetching only the units the
    payload actually uses.

    The units buffer is allocated for the WORST-case stream (160 units per
    8x8 block); real payloads use a few percent of that, so fetching the
    whole buffer wastes ~30-100x in interconnect bytes (and wall time on a
    slow link). Fetch the tiny bit_lengths first, trim the unit axis to the
    used maximum on device (see trim_units_count), then fetch."""
    bits = np.asarray(packed.bit_lengths)
    u_trim = trim_units_count(bits, packed.units.shape[-1])
    units = np.asarray(packed.units[..., :u_trim])
    return PackedStripes(units=units, bit_lengths=bits)


def symbol_chunks(
    symbols: RLEBlocks | RLEPositional,
    mode: str,
    cat_lengths: jax.Array | None = None,
    cat_codes: jax.Array | None = None,
    val_lengths: jax.Array | None = None,
    val_codes: jax.Array | None = None,
    vmin: int = 0,
    esc_index: int = 0,
    run_lengths: jax.Array | None = None,
    run_codes: jax.Array | None = None,
    run_bits: int = 8,
):
    """Per-symbol (chunk_values (B,S,3) uint32, chunk_lens (B,S,3) int32).

    Dead symbol slots get zero-length chunks (they advance neither offsets
    nor output bits, so both the compacted and positional layouts pack to
    identical streams). Accepts compacted RLEBlocks (live = slot < count) or
    positional RLEPositional (live = is_sym) — the hot path uses the latter,
    skipping compaction entirely.

    run_lengths/run_codes: canonical run-code table for cfg.coded_runs mode;
    None = the reference's fixed 8-bit run field (entropy.c:390).
    """
    if isinstance(symbols, RLEPositional):
        values, runs, live = symbols.values, symbols.runs, symbols.is_sym
        B, S = values.shape
    else:
        values, runs, counts = symbols
        B, S = values.shape
        s_idx = jax.lax.broadcasted_iota(jnp.int32, (B, S), 1)
        live = s_idx < counts[:, None]

    if run_lengths is not None:
        run_v = jnp.asarray(run_codes, jnp.uint32)[runs]
        run_l = jnp.where(live, jnp.asarray(run_lengths, jnp.int32)[runs], 0)
    else:
        run_v = runs.astype(jnp.uint32)
        run_l = jnp.where(live, run_bits, 0).astype(jnp.int32)

    if mode == "category":
        cats = hf.category_of(values)
        # 16-bin one-hot contraction instead of a per-element table gather
        # (whether a gather is cheaper on the GPU is ROADMAP D4)
        oh = (cats[..., None] == jnp.arange(hf.NUM_CATEGORIES)).astype(jnp.int32)
        a_v = jnp.sum(
            oh * jnp.asarray(cat_codes, jnp.uint32).astype(jnp.int32), axis=-1
        ).astype(jnp.uint32)
        a_l = jnp.sum(oh * jnp.asarray(cat_lengths, jnp.int32), axis=-1)
        b_v = hf.category_extra_bits(values, cats)
        b_l = cats
    elif mode == "direct":
        n_alpha = val_lengths.shape[0] - 1  # last entry is ESC
        shifted = values - vmin
        in_range = (shifted >= 0) & (shifted < n_alpha)
        idx = jnp.where(in_range, shifted, n_alpha)
        a_v = jnp.asarray(val_codes, jnp.uint32)[idx]
        a_l = jnp.asarray(val_lengths, jnp.int32)[idx]
        b_v = (values.astype(jnp.int32) & 0xFFFF).astype(jnp.uint32)
        b_l = jnp.where(in_range, 0, 16)
    elif mode == "none":
        a_v = (values.astype(jnp.int32) & 0xFFFF).astype(jnp.uint32)
        a_l = jnp.full((B, S), 16, jnp.int32)
        b_v = jnp.zeros((B, S), jnp.uint32)
        b_l = jnp.zeros((B, S), jnp.int32)
    else:
        raise ValueError(f"unknown huffman mode {mode!r}")

    a_l = jnp.where(live, a_l, 0)
    b_l = jnp.where(live, b_l, 0)
    cv = jnp.stack([a_v, b_v, run_v], axis=-1)
    cl = jnp.stack([a_l, b_l, run_l], axis=-1)
    return cv.astype(jnp.uint32), cl


def pack_chunks(
    chunk_values: jax.Array, chunk_lens: jax.Array, units_capacity: int
) -> PackedStripes:
    """Pack (n_stripes, C, 3) chunks into 16-bit stream units per stripe.

    chunk bit offsets = exclusive cumsum of lengths along the stripe's
    flattened chunk axis. Each chunk (<=16 bits) spans at most two units; its
    32-bit window aligned at the owning unit is split hi/lo and
    scatter-added. Disjoint bit ranges guarantee add == bitwise-or.
    """
    n_stripes = chunk_values.shape[0]
    cv = chunk_values.reshape(n_stripes, -1).astype(jnp.uint32)
    cl = chunk_lens.reshape(n_stripes, -1).astype(jnp.int32)

    csum = jnp.cumsum(cl, axis=1)
    offs = csum - cl  # exclusive
    bit_lengths = csum[:, -1]

    unit_idx = offs >> 4
    sh = offs & 15
    shift = 32 - cl - sh
    live = cl > 0
    # guard the undefined <<32 case (dead chunks)
    shift = jnp.clip(shift, 0, 31)
    window = jnp.where(live, cv << shift.astype(jnp.uint32), jnp.uint32(0))
    hi = (window >> 16).astype(jnp.int32)
    lo = (window & 0xFFFF).astype(jnp.int32)

    dump = units_capacity
    i0 = jnp.where(live, unit_idx, dump)
    i1 = jnp.where(live & (lo > 0), unit_idx + 1, dump)
    i1 = jnp.minimum(i1, dump)

    buf = jnp.zeros((n_stripes, units_capacity + 1), jnp.int32)
    rows = jnp.arange(n_stripes)[:, None]
    buf = buf.at[rows, i0].add(hi, mode="drop")
    buf = buf.at[rows, i1].add(lo, mode="drop")
    return PackedStripes(
        units=buf[:, :units_capacity].astype(jnp.uint16),
        bit_lengths=bit_lengths,
    )


def _pack_one_stripe_gather(cv: jax.Array, cl: jax.Array, units_capacity: int):
    """Scatter-free packing of one stripe's chunk stream (the hot path).

    Instead of scattering each chunk's two 16-bit-unit contributions into
    the output, this inverts
    the mapping with a prefix-sum identity: contributions to unit u are

        buf[u] = W_hi[K(u)] - W_hi[K(u-1)] + W_lo[K(u-1)] - W_lo[K(u-2)]

    where W_* are inclusive prefix sums of each chunk's hi/lo window halves
    in stream order and K(u) = #chunks with unit index <= u (one vectorized
    searchsorted — chunk unit indices are sorted because offsets are a
    cumsum). Bit-disjointness makes the telescoping sums exact. Prefix sums
    are split into 8-bit halves so int32 never overflows (255 * C_max with
    C_max = 192 * blocks_per_stripe keeps us under 2^31 for any stripe below
    ~43k blocks — asserted by the caller).

    All gathers, cumsums and compares — no scatter anywhere.
    """
    cv = cv.astype(jnp.uint32)
    cl = cl.astype(jnp.int32)
    csum = jnp.cumsum(cl)
    offs = csum - cl
    bits = csum[-1]

    i0 = offs >> 4
    sh = offs & 15
    shift = jnp.clip(32 - cl - sh, 0, 31).astype(jnp.uint32)
    window = jnp.where(cl > 0, cv << shift, jnp.uint32(0))
    hi = (window >> 16).astype(jnp.int32)
    lo = (window & 0xFFFF).astype(jnp.int32)

    def prefix(x):
        a = jnp.cumsum(x >> 8)
        b = jnp.cumsum(x & 0xFF)
        z = jnp.zeros(1, jnp.int32)
        return jnp.concatenate([z, a]), jnp.concatenate([z, b])

    hi_a, hi_b = prefix(hi)
    lo_a, lo_b = prefix(lo)

    u = jnp.arange(units_capacity, dtype=jnp.int32)
    k = jnp.searchsorted(i0, u, side="right").astype(jnp.int32)
    z1 = jnp.zeros(1, jnp.int32)
    km1 = jnp.concatenate([z1, k[:-1]])   # K(u-1); K(-1) = 0
    km2 = jnp.concatenate([z1, km1[:-1]])  # K(u-2)

    buf = (
        ((hi_a[k] - hi_a[km1]) << 8) + (hi_b[k] - hi_b[km1])
        + ((lo_a[km1] - lo_a[km2]) << 8) + (lo_b[km1] - lo_b[km2])
    )
    return buf, bits


def pack_chunks_gather(
    chunk_values: jax.Array, chunk_lens: jax.Array, units_capacity: int
) -> PackedStripes:
    """Gather-based packer (see _pack_one_stripe_gather), vmapped over
    stripes. Produces byte-identical streams to pack_chunks (tested)."""
    n_stripes = chunk_values.shape[0]
    cv = chunk_values.reshape(n_stripes, -1)
    cl = chunk_lens.reshape(n_stripes, -1)
    if cv.shape[1] * 255 >= 2**31:
        raise ValueError("stripe too large for 8-bit-split prefix sums")
    buf, bits = jax.vmap(
        lambda v, l: _pack_one_stripe_gather(v, l, units_capacity)
    )(cv, cl)
    return PackedStripes(units=buf.astype(jnp.uint16), bit_lengths=bits)


def pack_chunks_tiled(
    chunk_values: jax.Array,
    chunk_lens: jax.Array,
    units_capacity: int,
    tile: int = 256,
) -> PackedStripes:
    """Scatter-free, gather-free packer — the production path.

    Key structural bound: a tile of T chunks covers at most T*16 bits = T
    stream units, so per tile the segment-sum over sorted unit keys is a
    DENSE local problem:

        H[s, t, u] = sum_c w[s, t, c] * [key[s, t, c] - base[s, t] == u]

    computed as one fused broadcast-compare-reduce (static shapes; XLA
    fuses the (S, T, tile, SPAN) broadcast into the reduction). Tiles are
    then combined by log2(T) levels of pairwise span merges — contiguous
    window adds, the only data-dependent placement left.

    Byte-identical to pack_chunks (tested).
    """
    n_stripes = chunk_values.shape[0]
    cv = chunk_values.reshape(n_stripes, -1).astype(jnp.uint32)
    cl = chunk_lens.reshape(n_stripes, -1).astype(jnp.int32)
    C = cv.shape[1]

    csum = jnp.cumsum(cl, axis=1)
    offs = csum - cl
    bit_lengths = csum[:, -1]

    i0 = offs >> 4
    sh = offs & 15
    shift = jnp.clip(32 - cl - sh, 0, 31).astype(jnp.uint32)
    window = jnp.where(cl > 0, cv << shift, jnp.uint32(0))
    hi = (window >> 16).astype(jnp.float32)
    lo = (window & 0xFFFF).astype(jnp.float32)

    C_pad = -(-C // tile) * tile
    if C_pad != C:
        pad = C_pad - C
        i0 = jnp.pad(i0, ((0, 0), (0, pad)), mode="edge")
        hi = jnp.pad(hi, ((0, 0), (0, pad)))
        lo = jnp.pad(lo, ((0, 0), (0, pad)))
    T = C_pad // tile
    span = tile + 128  # tile units + lo spill, 128-aligned

    k = i0.reshape(n_stripes, T, tile)
    whi = hi.reshape(n_stripes, T, tile)
    wlo = lo.reshape(n_stripes, T, tile)
    base = k[:, :, 0]  # (S, T)
    local = k - base[:, :, None]  # in [0, tile]

    u = jnp.arange(span, dtype=jnp.int32)
    # fused broadcast-compare-reduce; intermediate (S, T, tile, span) never
    # materializes (reduce fusion)
    H = jnp.sum(
        whi[..., None] * (local[..., None] == u), axis=2
    ) + jnp.sum(
        wlo[..., None] * ((local[..., None] + 1) == u), axis=2
    )
    H = H.astype(jnp.int32)  # (S, T, span); exact: values < 2^16

    # Tree combine: log2(T) levels of pairwise span merges. Merging two
    # adjacent spans (widths W at bases b0 <= b1, with b1 - b0 <= level
    # chunk capacity * 16 bits / 16 = level tile units) yields one dense
    # span of width 2W at base b0 — still local, so the combine never
    # degenerates to global scatter. Each level is two vmapped dynamic
    # window adds over all pairs (contiguous rows — no per-element ops).
    spans = H  # (S, M, W)
    bases = base  # (S, M)
    level_tile = tile
    while spans.shape[1] > 1:
        S_, M, W = spans.shape
        if M % 2:
            spans = jnp.pad(spans, ((0, 0), (0, 1), (0, 0)))
            bases = jnp.concatenate(
                [bases, bases[:, -1:] ], axis=1
            )  # duplicate last base; padded span is all zero
            M += 1
        even, odd = spans[:, 0::2], spans[:, 1::2]
        b_even, b_odd = bases[:, 0::2], bases[:, 1::2]
        d = b_odd - b_even  # in [0, level_tile]
        W2 = W + level_tile + 128

        def merge(e_row, o_row, d_row):
            out = jnp.zeros(W2, jnp.int32).at[:W].set(e_row)
            cur = jax.lax.dynamic_slice(out, (d_row,), (W,))
            return jax.lax.dynamic_update_slice(out, cur + o_row, (d_row,))

        spans = jax.vmap(jax.vmap(merge))(even, odd, d)
        bases = b_even
        level_tile *= 2
        # anything beyond capacity is worst-case padding slack — trim to
        # keep level buffers bounded
        max_w = units_capacity + 256
        if spans.shape[2] > max_w:
            spans = spans[:, :, :max_w]

    U_pad = units_capacity + spans.shape[2] + 128
    buf = jnp.zeros((n_stripes, U_pad), jnp.int32)
    # final placement: single span per stripe at its base (= first chunk's
    # unit, which is 0 for a stream starting at bit 0 — but keep it general)
    def place(row, srow, brow):
        cur = jax.lax.dynamic_slice(row, (brow,), (srow.shape[0],))
        return jax.lax.dynamic_update_slice(row, cur + srow, (brow,))

    buf = jax.vmap(place)(buf, spans[:, 0], bases[:, 0])
    return PackedStripes(
        units=buf[:, :units_capacity].astype(jnp.uint16),
        bit_lengths=bit_lengths,
    )


def stripes_to_bytes(packed: PackedStripes) -> list[bytes]:
    """Host epilogue: unit buffers -> per-stripe byte strings (big-endian
    16-bit units, truncated to the actual byte length)."""
    units = np.asarray(packed.units).astype(np.uint16)
    bits = np.asarray(packed.bit_lengths)
    out = []
    for s in range(units.shape[0]):
        n_bytes = int((bits[s] + 7) // 8)
        raw = units[s].astype(">u2").tobytes()
        out.append(raw[:n_bytes])
    return out


class BitReader:
    """MSB-first bit reader over bytes (host-side decode)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_bit(self) -> int:
        byte = self.data[self.pos >> 3]
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    @property
    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos


class BitWriter:
    """MSB-first bit writer (host-side reference packer, used to cross-check
    the device scatter packer bit-for-bit)."""

    __slots__ = ("buf", "acc", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write_bits(self, value: int, n: int):
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def getvalue(self) -> bytes:
        out = bytearray(self.buf)
        if self.nbits:
            out.append((self.acc << (8 - self.nbits)) & 0xFF)
        return bytes(out)

    @property
    def bit_length(self) -> int:
        return len(self.buf) * 8 + self.nbits


def pack_stripes_host(
    symbols_per_stripe,
    mode: str,
    cat_table: "hf.CanonicalTable | None" = None,
    val_table: "hf.CanonicalTable | None" = None,
    vmin: int = 0,
    n2: int = 64,
    run_table: "hf.CanonicalTable | None" = None,
) -> list[bytes]:
    """Host (NumPy) packer with identical wire format — the oracle for the
    device scatter packer. symbols_per_stripe: list of (values, runs) numpy
    pairs, already restricted to live symbols, concatenated per stripe.
    run_table: canonical run-code table (cfg.coded_runs); None = the
    fixed-width run field."""
    rb = run_field_bits(n2)
    out = []
    for values, runs in symbols_per_stripe:
        w = BitWriter()
        for v, r in zip(values.tolist(), runs.tolist()):
            if mode == "category":
                c = int(abs(v)).bit_length()
                w.write_bits(int(cat_table.codes[c]), int(cat_table.lengths[c]))
                if c:
                    extra = v if v > 0 else v + (1 << c) - 1
                    w.write_bits(int(extra), c)
            elif mode == "direct":
                n_alpha = len(val_table.lengths) - 1
                idx = v - vmin
                if 0 <= idx < n_alpha and val_table.lengths[idx] > 0:
                    w.write_bits(int(val_table.codes[idx]), int(val_table.lengths[idx]))
                else:
                    w.write_bits(
                        int(val_table.codes[n_alpha]), int(val_table.lengths[n_alpha])
                    )
                    w.write_bits(v & 0xFFFF, 16)
            elif mode == "none":
                w.write_bits(v & 0xFFFF, 16)
            if run_table is not None:
                w.write_bits(int(run_table.codes[r]), int(run_table.lengths[r]))
            else:
                w.write_bits(r, rb)
        out.append(w.getvalue())
    return out


def unpack_stripe_host(
    data: bytes,
    n_blocks: int,
    n2: int,
    mode: str,
    cat_table: "hf.CanonicalTable | None" = None,
    val_table: "hf.CanonicalTable | None" = None,
    vmin: int = 0,
    expected_bits: int | None = None,
    run_table: "hf.CanonicalTable | None" = None,
) -> np.ndarray:
    """Decode one stripe substream -> (n_blocks, n2) zigzag coefficients.

    Uses the decoder position invariant (ops/rle.py): a block is complete
    when pos reaches n2, so no symbol counts are stored.

    expected_bits: when given, raise ValueError unless the decode consumed
    exactly that many bits — the container records each stripe's bit length,
    so a mismatch is a corruption signal (models/recovery.py).
    """
    r = BitReader(data)
    # int16: the wire's coefficient space (matches the native decoder's
    # output so the two decoders stay byte-identical, not just value-equal)
    out = np.zeros((n_blocks, n2), np.int16)
    for b in range(n_blocks):
        pos = 0
        while pos < n2:
            if mode == "category":
                c = cat_table.decode_one(r)
                if c > 15:
                    # categories above 15 exceed the int16 coefficient
                    # space — foreign/corrupt table; the native decoder
                    # rejects identically (err=2)
                    raise ValueError(f"category {c} exceeds the wire range")
                if c:
                    extra = r.read_bits(c)
                    v = int(hf.value_from_category(np.int32(c), np.int64(extra)))
                else:
                    v = 0
            elif mode == "direct":
                sym = val_table.decode_one(r)
                n_alpha = len(val_table.lengths) - 1
                if sym == n_alpha:  # ESC
                    raw = r.read_bits(16)
                    v = raw - 0x10000 if raw >= 0x8000 else raw
                else:
                    v = sym + vmin
                    if not -0x8000 <= v <= 0x7FFF:
                        # outside the wire's int16 coefficient space —
                        # only reachable with a foreign/corrupt table
                        # (hostile alpha/vmin header fields); the native
                        # decoder rejects identically (err=2) instead of
                        # wrapping, keeping the two decoders byte-identical
                        # on rejection as well as success
                        raise ValueError(
                            f"direct value {v} exceeds the wire range"
                        )
            else:
                raw = r.read_bits(16)
                v = raw - 0x10000 if raw >= 0x8000 else raw
            if run_table is not None:
                run = run_table.decode_one(r)
            else:
                run = r.read_bits(run_field_bits(n2))
            pos += run
            if pos < n2:
                out[b, pos] = v
                pos += 1
    if expected_bits is not None and r.pos != expected_bits:
        raise ValueError(
            f"stripe consumed {r.pos} bits, container records {expected_bits}"
        )
    return out
