"""The staged device packer (codec.encode_pack -> bitstream.pack_chunks)
must write byte-identical stripes to the host reference packer
(bitstream.pack_stripes_host) for every config the codec accepts: block
sizes, adaptive quantization, DC prediction, coded runs, the three
entropy modes, blocks per stripe and quality, plus extreme content.

pack_chunks is the only device packer, so these grids pin the whole
device half of the wire format against a bit-at-a-time writer.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from dct_tpu.config import CodecConfig
from dct_tpu.models import codec
from dct_tpu.ops import bitstream as bs
from dct_tpu.ops import huffman as hf
from dct_tpu.ops import quant, rle, transform


def _blocks(nb: int, n2: int, seed: int, amp_step: float = 7.0):
    """(nb, n2) u8 blocks with mixed per-block detail: uniform-random
    blocks all saturate the adaptive variance clamp (scale exactly 1.0),
    which would make the adaptive path vacuous."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 216, (nb, 1)).astype(np.float64)
    amp = (np.arange(nb) % 9).reshape(nb, 1) * amp_step
    px = np.clip(base + rng.normal(0, 1, (nb, n2)) * amp, 0, 255)
    return jnp.asarray(px.astype(np.uint8))


def _arrays(t: hf.CanonicalTable | None):
    return codec._table_arrays(t)


def _direct_table(sym) -> hf.CanonicalTable:
    """A direct-mode table over this content (every value kept encodable,
    ESC weighted in)."""
    vals = np.asarray(sym.values)[np.asarray(sym.is_sym)]
    hist = np.ones(codec.DIRECT_ALPHABET + 2, np.int64)
    idx = vals - codec.DIRECT_VMIN
    idx = idx[(idx >= 0) & (idx < codec.DIRECT_ALPHABET)]
    np.add.at(hist, idx, 3)
    hist[codec.DIRECT_ALPHABET] += 5  # ESC
    return hf.CanonicalTable.from_frequencies(hist[: codec.DIRECT_ALPHABET + 1])


def _check(pixels, cfg: CodecConfig, n_stripes: int, *, table=None,
           run_table=None, dc=False):
    """Encode `pixels` through transform -> [DC prediction] -> positional
    RLE, then pack on the device and on the host; assert identical
    bytes, bit lengths, and an all-zero tail past each payload."""
    scale = None
    if cfg.adaptive:
        var = quant.block_variance_flat(transform.level_shift(pixels))
        scale = quant.scale_from_variance_code(quant.variance_code(var))
    zz = transform.encode_blocks(pixels, cfg, adaptive_scale=scale)
    if dc:
        zz = codec.dc_predict(zz, n_stripes)
    sym = rle.rle_encode_positional(zz)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    if mode == "direct" and table is None:
        table = _direct_table(sym)
    if mode == "category" and table is None:
        table = hf.default_category_table(cfg.quality)
    if cfg.coded_runs and run_table is None:
        run_table = hf.default_run_table(cfg.quality)
    lengths, codes = _arrays(table)
    rl, rc = _arrays(run_table) if cfg.coded_runs else (None, None)

    packed = codec.encode_pack(sym, cfg, n_stripes, lengths, codes, rl, rc)
    got = bs.stripes_to_bytes(packed)

    v = np.asarray(sym.values)
    r = np.asarray(sym.runs)
    m = np.asarray(sym.is_sym)
    bps = v.shape[0] // n_stripes
    per = []
    for s in range(n_stripes):
        rows = slice(s * bps, (s + 1) * bps)
        per.append((v[rows][m[rows]], r[rows][m[rows]]))
    want = bs.pack_stripes_host(
        per, mode,
        cat_table=table if mode == "category" else None,
        val_table=table if mode == "direct" else None,
        vmin=codec.DIRECT_VMIN, n2=cfg.n2,
        run_table=run_table if cfg.coded_runs else None,
    )
    assert got == want
    bits = np.asarray(packed.bit_lengths)
    assert [(int(b) + 7) // 8 for b in bits] == [len(w) for w in want]
    units = np.asarray(packed.units)
    for s in range(n_stripes):
        assert not units[s, (int(bits[s]) + 15) // 16:].any()
    return zz, packed, table, run_table


@pytest.mark.parametrize("bps", [8, 9])
@pytest.mark.parametrize("adaptive", [False, True])
def test_packer_coded_runs(bps, adaptive):
    cfg = CodecConfig(
        quality=50, adaptive=adaptive, static_tables=True, coded_runs=True
    )
    _check(_blocks(3 * bps, 64, 3 * bps + adaptive), cfg, 3)


@pytest.mark.parametrize("bps", [8, 9, 30])  # even + odd blocks per stripe
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("quality", [10, 50, 95])
def test_packer_matches_host(bps, adaptive, quality):
    cfg = CodecConfig(quality=quality, adaptive=adaptive, static_tables=True)
    _check(_blocks(3 * bps, 64, 3 * bps * quality + adaptive), cfg, 3)


@pytest.mark.parametrize("bps", [8, 9, 30])
@pytest.mark.parametrize("coded_runs", [False, True])
def test_packer_dc_prediction(bps, coded_runs):
    """Stripe-local DC DPCM deltas (larger DC magnitudes, stripe-first
    blocks raw) through both packers."""
    cfg = CodecConfig(
        quality=50, static_tables=True, dc_prediction=True,
        coded_runs=coded_runs,
    )
    _check(_blocks(3 * bps, 64, 1000 + 3 * bps + coded_runs), cfg, 3,
           dc=True)


def test_packer_extreme_pixels():
    """All-extreme blocks drive max-magnitude coefficients (largest
    categories) plus all-zero AC tails (terminal-zero symbols)."""
    cfg = CodecConfig(quality=100, static_tables=True)  # q100: divisor 1
    checker = (
        (np.indices((8, 8)).sum(0) & 1) * 255
    ).astype(np.uint8).reshape(1, 64)
    flat0 = np.zeros((1, 64), np.uint8)
    flat255 = np.full((1, 64), 255, np.uint8)
    pixels = jnp.asarray(np.concatenate([checker, flat0, flat255, checker]))
    _check(pixels, cfg, 2)


@pytest.mark.parametrize("block", [4, 8, 16])
@pytest.mark.parametrize(
    "adaptive,dc,runs,quality",
    [(False, False, False, 50), (True, True, True, 30), (False, True, False, 90)],
)
def test_packer_block_sizes(block, adaptive, dc, runs, quality):
    """Every feature combination at every block size, including 16x16's
    9-bit fixed run field (coded runs cover 0..64 only)."""
    cfg = CodecConfig(
        quality=quality, block_size=block, adaptive=adaptive,
        static_tables=True, coded_runs=runs and block <= 8, dc_prediction=dc,
    )
    rng = np.random.default_rng(block * 100 + quality)
    px = jnp.asarray(rng.integers(0, 256, (3 * 17, block * block)), jnp.uint8)
    _check(px, cfg, 3, dc=dc)


@pytest.mark.parametrize("mode", ["none", "direct"])
@pytest.mark.parametrize("full", [False, True])
def test_packer_direct_and_none_modes(mode, full):
    """Raw 16-bit "none" mode and per-value "direct" mode (511 values +
    ESC), alone and with adaptive + dc_prediction + coded_runs."""
    use_h = mode != "none"
    cfg = CodecConfig(
        quality=40, use_huffman=use_h,
        huffman_mode=mode if use_h else "category",
        adaptive=full, dc_prediction=full, coded_runs=full,
    )
    rng = np.random.default_rng(99)
    px = jnp.asarray(rng.integers(0, 256, (3 * 17, 64)), jnp.uint8)
    _check(px, cfg, 3, dc=full)


@pytest.mark.parametrize("content", ["smooth", "dense"])
@pytest.mark.parametrize("quality", [5, 20, 35, 60, 75, 85, 97, 100])
def test_packer_quality_sweep(quality, content):
    """Symbol density changes several-fold with quality; per-image tables
    built from this content's own histograms (the dynamic-table path)."""
    cfg = CodecConfig(quality=quality, coded_runs=True)
    amp = 2.0 if content == "smooth" else 12.0
    px = _blocks(4 * 20, 64, quality, amp_step=amp)
    zz = transform.encode_blocks(px, cfg)
    sym = rle.rle_encode_positional(zz)
    table = hf.CanonicalTable.from_frequencies(
        np.asarray(hf.category_histogram_masked(sym.values, sym.is_sym))
    )
    run_table = codec._build_run_table(
        cfg, np.asarray(hf.run_histogram_masked(sym.runs, sym.is_sym))
    )
    _check(px, cfg, 4, table=table, run_table=run_table)


def test_packer_worst_case_direct_coded_runs():
    """direct + coded runs at q100 on random content: most values escape
    (16-bit code + 16-bit raw + run code per symbol), the densest stream
    the format allows; the worst-case units buffer must hold it."""
    cfg = CodecConfig(
        quality=100, huffman_mode="direct", coded_runs=True,
    )
    rng = np.random.default_rng(3)
    px = jnp.asarray(rng.integers(0, 256, (2 * 17, 64)), jnp.uint8)
    _, packed, _, _ = _check(px, cfg, 2)
    cap = 17 * bs.units_per_block_worst(64, True)
    assert packed.units.shape[1] == cap
    assert int(np.asarray(packed.bit_lengths).max()) <= 16 * cap


@pytest.mark.parametrize("mode", ["category", "direct", "none"])
def test_packed_stripes_decode_on_host(mode):
    """Device-packed stripes read back through the host decoder give the
    coefficients that were packed."""
    use_h = mode != "none"
    cfg = CodecConfig(
        quality=45, use_huffman=use_h,
        huffman_mode=mode if use_h else "category", coded_runs=True,
    )
    zz, packed, table, run_table = _check(_blocks(2 * 12, 64, 5), cfg, 2)
    stripes = bs.stripes_to_bytes(packed)
    got = np.concatenate([
        bs.unpack_stripe_host(
            stripes[s], 12, 64, mode,
            cat_table=table if mode == "category" else None,
            val_table=table if mode == "direct" else None,
            vmin=codec.DIRECT_VMIN, run_table=run_table,
            expected_bits=int(np.asarray(packed.bit_lengths)[s]),
        )
        for s in range(2)
    ])
    np.testing.assert_array_equal(got, np.asarray(zz))
