"""Device-side entropy decode: packed stripe bytes -> zigzag coefficients.

The decode mirror of ops/bitstream.py's packer (reference mirror:
entropy.c:333-358 run_length_decode + the canonical-Huffman walk the
reference never wires to bits, SURVEY.md B2). The host decoders (Python
``bitstream.unpack_stripe_host``, C++ ``native/bitpack.cpp``) are the
oracles; this decoder produces identical integers on the device, so
``decode_to_device`` never round-trips coefficients through the host.

Parallelization: entropy decode is bit-serial per substream, so the unit
of parallelism is whatever the format can address independently. With
cfg.decode_index (container v2) every BLOCK's bit length is stored — the
restart-marker analog — so every block of the plane decodes at once, each
with its own bit cursor (its stripe's start plus the exclusive prefix sum
of the block lengths before it). One ``lax.while_loop`` iteration decodes
one symbol of every still-active block:

  1. gather two 32-bit words at the block's cursor (a 33..64-bit window);
  2. canonical-decode the <= 16-bit code against per-length
     first/limit/base arrays;
  3. read the mode's payload: category extra bits, direct ESC raw 16
     bits, or the raw 16-bit value of "none" mode;
  4. gather the run field at the advanced cursor (fixed width or a second
     canonical decode);
  5. RLE-expand (entropy.c:344-352): pos += run; write the value if
     pos < n2; ++pos.

The loop ends when every block's cursor reaches its end or its position
reaches n2; pos grows by at least one per iteration, so a corrupt stream
cannot keep it running past n2 iterations.

Streams whose tables exceed 16-bit codes or whose direct values leave
int16 (possible only in hostile containers; this encoder's tables are
length-limited) take the host decoder instead — callers gate on
``tables_supported``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dct_tpu.ops import huffman as hf

_ESC_SENTINEL = 1 << 20  # marks the ESC slot in the direct value table


def _canon_arrays(table: "hf.CanonicalTable") -> tuple[np.ndarray, np.ndarray]:
    """((3, 17) first/limit/base per code length 1..16, index 0 unused;
    the canonical-order symbol list)."""
    canon = np.zeros((3, 17), np.int32)
    for L in range(1, 17):
        idx = np.nonzero(table.sorted_lengths == L)[0]
        if idx.size:
            canon[0, L] = int(table.sorted_codes[idx[0]])
            canon[1, L] = int(table.sorted_codes[idx[-1]]) + 1
            canon[2, L] = int(idx[0])
    return canon, table.sorted_symbols.astype(np.int32)


def tables_supported(
    table: "hf.CanonicalTable | None",
    run_table: "hf.CanonicalTable | None",
    vmin: int = 0,
) -> bool:
    """Whether the device decoder can represent these wire tables: every
    code <= 16 bits and direct values inside int16 (the host decoders
    reject wider values too — bitstream.unpack_stripe_host)."""
    for t in (table, run_table):
        if t is not None and t.sorted_lengths.size and (
            int(t.sorted_lengths.max()) > 16
        ):
            return False
    if table is not None and not (
        -0x8000 <= vmin and vmin + len(table.lengths) <= 0x8001
    ):
        return False
    return True


def table_operands(
    table: "hf.CanonicalTable | None",
    run_table: "hf.CanonicalTable | None",
    mode: str,
    vmin: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host prep of the decoder's table operands: (value canon (3, 17),
    value symbols, run canon (3, 17), run symbols). Value symbols are the
    categories (category mode) or the decoded values with ESC marked by a
    sentinel (direct mode), padded to a multiple of 64 so tables of
    similar size share one compiled shape."""
    vcanon = np.zeros((3, 17), np.int32)
    vsym = np.zeros(1, np.int32)
    if mode in ("category", "direct"):
        vcanon, order = _canon_arrays(table)
        if mode == "direct":
            n_alpha = len(table.lengths) - 1
            order = np.where(
                order == n_alpha, _ESC_SENTINEL, order + vmin
            ).astype(np.int32)
        vsym = np.zeros(max(64, -(-order.size // 64) * 64), np.int32)
        vsym[: order.size] = order
    rcanon = np.zeros((3, 17), np.int32)
    rsym = np.zeros(1, np.int32)
    if run_table is not None:
        rcanon, rorder = _canon_arrays(run_table)
        rsym = np.zeros(max(64, -(-rorder.size // 64) * 64), np.int32)
        rsym[: rorder.size] = rorder
    return vcanon, vsym, rcanon, rsym


def stripe_words(stripes: list[bytes]) -> np.ndarray:
    """Stripe substreams -> (n_stripes, n_words) uint32 big-endian words,
    zero-padded. Every row keeps at least one zero word past its data, so
    the decoder's two-word window never reads another stripe. n_words is
    a power of two (>= 64) so streams of similar size share one compiled
    shape."""
    need = max((len(s) + 3) // 4 for s in stripes) + 1
    n_words = max(64, 1 << (need - 1).bit_length())
    buf = np.zeros((len(stripes), 4 * n_words), np.uint8)
    for s, data in enumerate(stripes):
        buf[s, : len(data)] = np.frombuffer(data, np.uint8)
    return buf.view(">u4").astype(np.uint32)


def _peek32(flat_words: jax.Array, row_base: jax.Array, p: jax.Array):
    """The 32 stream bits starting at bit p of each block's stripe row."""
    w = row_base + (p >> 5)
    o = (p & 31).astype(jnp.uint32)
    hi = flat_words[w]
    lo = flat_words[w + 1]
    lo = jnp.where(o > 0, lo >> jnp.where(o > 0, 32 - o, 0), 0)
    return (hi << o) | lo


def _canon_decode(t16: jax.Array, canon: jax.Array):
    """<= 16-bit canonical decode of each block's next code (the top 16
    bits of the window, int32): (canonical index, code length; 0 if no
    code matches). Shorter lengths are tried last so they win, which is
    the prefix-code order."""
    idx = jnp.zeros_like(t16)
    ln = jnp.zeros_like(t16)
    for L in range(16, 0, -1):
        cand = t16 >> (16 - L)
        hit = (cand >= canon[0, L]) & (cand < canon[1, L])
        idx = jnp.where(hit, canon[2, L] + cand - canon[0, L], idx)
        ln = jnp.where(hit, L, ln)
    return idx, ln


def _signed16(u: jax.Array) -> jax.Array:
    """Low 16 bits of a uint32 as a two's-complement int32."""
    v = (u & 0xFFFF).astype(jnp.int32)
    return v - ((v >> 15) & 1) * 0x10000


def decode_blocks(
    words: jax.Array,
    block_bits: jax.Array,
    vcanon: jax.Array,
    vsym: jax.Array,
    rcanon: jax.Array,
    rsym: jax.Array,
    *,
    n2: int,
    mode: str,
    coded_runs: bool,
    run_bits: int,
) -> jax.Array:
    """Traced decode: (S, n_words) uint32 stripe words + (S, bps) per-block
    bit lengths -> (S * bps, n2) int32 zigzag coefficients, identical to
    the host decoders. Blocks of length 0 (mesh-pad stripes) decode to
    zeros. Jittable and shard_map-able over the stripe axis (stripes are
    independent). See table_operands / stripe_words for the host prep."""
    n_stripes, n_words = words.shape
    bps = block_bits.shape[1]
    nb = n_stripes * bps
    bb = block_bits.astype(jnp.int32)
    start = (jnp.cumsum(bb, axis=1) - bb).reshape(-1)
    end = start + bb.reshape(-1)
    row_base = jnp.repeat(jnp.arange(n_stripes, dtype=jnp.int32) * n_words, bps)
    flat_words = words.astype(jnp.uint32).reshape(-1)
    out_base = jnp.arange(nb, dtype=jnp.int32) * n2
    dump = nb * n2  # out-of-bounds scatter index: dropped

    def body(carry):
        cur, pos, out = carry
        active = (pos < n2) & (cur < end)
        t32 = _peek32(flat_words, row_base, cur)
        t16 = (t32 >> 16).astype(jnp.int32)
        if mode == "category":
            idx, ln = _canon_decode(t16, vcanon)
            cat = jnp.where(ln > 0, vsym[idx], 0)
            e = jnp.where(
                cat > 0,
                (t32 << ln.astype(jnp.uint32))
                >> (32 - jnp.maximum(cat, 1)).astype(jnp.uint32),
                0,
            ).astype(jnp.int32)
            half = 1 << jnp.maximum(cat - 1, 0)
            v = jnp.where(
                cat == 0, 0, jnp.where(e < half, e - (1 << cat) + 1, e)
            )
            gv = ln + cat
        elif mode == "direct":
            idx, ln = _canon_decode(t16, vcanon)
            sym = vsym[idx]
            esc = sym == _ESC_SENTINEL
            raw = _signed16((t32 << ln.astype(jnp.uint32)) >> 16)
            v = jnp.where(esc, raw, sym)
            gv = ln + jnp.where(esc, 16, 0)
        else:  # none: raw 16-bit two's-complement value
            v = _signed16(t32 >> 16)
            gv = jnp.full_like(t16, 16)

        t_run = _peek32(flat_words, row_base, cur + gv)
        if coded_runs:
            ridx, lc = _canon_decode((t_run >> 16).astype(jnp.int32), rcanon)
            run = rsym[ridx]
        else:
            run = (t_run >> (32 - run_bits)).astype(jnp.int32)
            lc = run_bits

        wpos = pos + run
        write = active & (wpos < n2)
        out = out.at[jnp.where(write, out_base + wpos, dump)].set(
            v, mode="drop"
        )
        pos = jnp.where(active, jnp.where(wpos < n2, wpos + 1, wpos), pos)
        cur = jnp.where(active, cur + gv + lc, cur)
        return cur, pos, out

    def cond(carry):
        cur, pos, _ = carry
        return jnp.any((pos < n2) & (cur < end))

    # carries built from `start` (zeros_like) share its varying mesh axes
    # when traced under shard_map, as while_loop requires
    init = (
        start,
        jnp.zeros_like(start),
        jnp.zeros_like(start, shape=(nb * n2,)),
    )
    _, _, out = jax.lax.while_loop(cond, body, init)
    return out.reshape(nb, n2)
