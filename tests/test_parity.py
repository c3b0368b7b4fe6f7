"""Golden-parity suite: the JAX pipeline vs the unmodified C reference,
linked behind build/liboracle.so (native/oracle_driver.c).

Parity contract for the float transform+quant front-end: the quantized
coefficients (three bf16 passes with f32 accumulation, see
tables.fused_encode_operator_split) equal the float64 oracle's EXCEPT at
coefficients whose true value sits exactly on a .5 rounding boundary
(|frac - 0.5| < 1e-6). Such ties are fp-rounding-order-dependent in any
implementation — the oracle itself rounds them through its own ~1e-14
accumulation error, and a GPU's tensor cores accumulate in another order
than the CPU — so the contract is: every mismatch must be an exact tie,
differ by at most 1, and stay under 1% of coefficients. The same
tolerance holds on the CPU and on the GPU (chip_smoke.py checks it there
against a float64 reference). Everything downstream of quantization
(zigzag, RLE, sizes, decode) is integer-domain and must match
bit-for-bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dct_tpu import tables
from dct_tpu.config import CodecConfig
from dct_tpu.ops import transform, quant, rle

QUALITIES = (1, 10, 25, 50, 75, 90, 100)


def _tie_tolerant_compare(oracle, px, fused, quality, max_rate=0.01):
    """Assert fused quantized coeffs match oracle except at exact .5 ties."""
    perm = tables.zigzag_permutation(8)
    qm = oracle.quant_matrix(8, quality).ravel()[perm]
    n_mism = 0
    for b in range(len(px)):
        want = oracle.quantize(
            oracle.dct_forward(px[b].astype(np.float64) - 128.0), quality
        ).ravel()[perm]
        mism = np.nonzero(fused[b] != want)[0]
        for k in mism:
            c = oracle.dct_forward(px[b].astype(np.float64) - 128.0).ravel()[perm][k]
            frac_dist = abs(abs(c / qm[k]) % 1.0 - 0.5)
            assert frac_dist < 1e-6, (
                f"non-tie mismatch: block {b} zz {k} coeff {c} q {qm[k]} "
                f"got {fused[b, k]} want {want[k]}"
            )
            assert abs(int(fused[b, k]) - int(want[k])) <= 1
            n_mism += 1
    assert n_mism / fused.size < max_rate


class TestQuantTables:
    @pytest.mark.parametrize("quality", QUALITIES)
    def test_quant_matrix_8(self, oracle, quality):
        np.testing.assert_allclose(
            tables.quant_matrix(8, quality), oracle.quant_matrix(8, quality),
            atol=1e-12,
        )

    @pytest.mark.parametrize("n", (4, 16, 32))
    def test_radial_matrix(self, oracle, n):
        """Non-8 block sizes use the synthetic radial table
        (quantization.c:81-95)."""
        np.testing.assert_allclose(
            tables.quant_matrix(n, 50), oracle.quant_matrix(n, 50), atol=1e-12
        )


class TestVariance:
    def test_matches_oracle(self, oracle):
        rng = np.random.default_rng(11)
        for _ in range(8):
            blk = rng.uniform(-128, 127, size=(8, 8))
            got = float(quant.block_variance(jnp.asarray(blk, jnp.float32)))
            assert abs(got - oracle.block_variance(blk)) < 0.5


class TestQuantizeDequantize:
    @pytest.mark.parametrize("quality", (10, 50, 90))
    def test_quantize_f64_inputs(self, oracle, quality):
        """Layer-level quantize on shared float coefficients: exact match
        (same inputs, only the round divides differ)."""
        rng = np.random.default_rng(12)
        coeffs = np.round(rng.uniform(-1000, 1000, size=(16, 8, 8)), 3)
        cfg = CodecConfig(quality=quality)
        got = np.asarray(quant.quantize(jnp.asarray(coeffs, jnp.float32), cfg))
        for b in range(16):
            want = oracle.quantize(coeffs[b], quality)
            # float32 cast of the input may flip exact ties; tolerate <=1 off
            diff = np.abs(got[b] - want)
            assert diff.max(initial=0) <= 1
            assert (diff > 0).mean() < 0.03

    def test_dequantize_compat_b1(self, oracle):
        """compat_b1 reproduces the reference's buggy non-adaptive dequant
        (multiply by 1/q, quantization.c:144)."""
        rng = np.random.default_rng(13)
        qc = rng.integers(-100, 100, size=(4, 8, 8)).astype(np.int32)
        cfg = CodecConfig(quality=50, compat_b1=True)
        got = np.asarray(quant.dequantize(jnp.asarray(qc), cfg))
        for b in range(4):
            want = oracle.dequantize(qc[b], 50)
            np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-5)

    def test_dequantize_correct_default(self, oracle):
        """Default dequant multiplies by q — differs from the buggy oracle by
        exactly q^2 per entry."""
        qc = np.ones((1, 8, 8), np.int32)
        cfg = CodecConfig(quality=50)
        got = np.asarray(quant.dequantize(jnp.asarray(qc), cfg))[0]
        qm = oracle.quant_matrix(8, 50)
        np.testing.assert_allclose(got, qm, rtol=1e-5)
        buggy = oracle.dequantize(qc[0], 50)
        np.testing.assert_allclose(got / buggy, qm * qm, rtol=1e-4)

    def test_adaptive_matches_oracle(self, oracle):
        """Adaptive quantize/dequantize vs reference adjust_matrix_for_block
        (quantization.c:171-211) across the variance range."""
        rng = np.random.default_rng(14)
        coeffs = rng.uniform(-500, 500, size=(8, 8))
        cfg = CodecConfig(quality=50, adaptive=True)
        for var in (0.0, 50.0, 300.0, 864.0, 5000.0):
            got_q = np.asarray(
                quant.quantize(
                    jnp.asarray(coeffs, jnp.float32)[None], cfg,
                    variance=jnp.asarray([var]),
                )
            )[0]
            want_q = oracle.quantize(coeffs, 50, adaptive=True, variance=var)
            assert np.abs(got_q - want_q).max(initial=0) <= 1
            qc = want_q
            got_d = np.asarray(
                quant.dequantize(
                    jnp.asarray(qc)[None], cfg, variance=jnp.asarray([var])
                )
            )[0]
            want_d = oracle.dequantize(qc, 50, adaptive=True, variance=var)
            np.testing.assert_allclose(got_d, want_d, rtol=1e-4, atol=1e-4)


class TestFusedParity:
    @pytest.mark.parametrize("quality", QUALITIES)
    def test_random_blocks(self, oracle, quality):
        rng = np.random.default_rng(quality)
        px = rng.integers(0, 256, size=(64, 8, 8)).astype(np.uint8)
        cfg = CodecConfig(quality=quality)
        fused = np.asarray(
            transform.encode_blocks(jnp.asarray(px.reshape(-1, 64)), cfg)
        )
        _tie_tolerant_compare(oracle, px, fused, quality)

    def test_golden_block_exact(self, oracle, golden_block):
        """The textbook block must match exactly at every quality."""
        perm = tables.zigzag_permutation(8)
        for quality in QUALITIES:
            cfg = CodecConfig(quality=quality)
            fused = np.asarray(
                transform.encode_blocks(
                    jnp.asarray(golden_block.reshape(1, 64)), cfg
                )
            )[0]
            want = oracle.quantize(
                oracle.dct_forward(golden_block.astype(np.float64) - 128.0),
                quality,
            ).ravel()[perm]
            np.testing.assert_array_equal(fused, want)

    def test_smooth_image_blocks_q50(self, oracle):
        """Natural-statistics blocks (smooth gradients + noise) at default
        quality. Ties occur even here (e.g. a true coefficient of exactly
        9.0 against step 18 is exactly 0.5), so the tie-tolerant contract
        applies at every quality."""
        rng = np.random.default_rng(42)
        yy, xx = np.mgrid[0:8, 0:8]
        px = []
        for _ in range(64):
            base = (
                128
                + 60 * np.sin(xx * rng.uniform(0.1, 0.8) + rng.uniform(0, 6))
                + 40 * np.cos(yy * rng.uniform(0.1, 0.8))
                + rng.normal(0, 6, size=(8, 8))
            )
            px.append(np.clip(base, 0, 255).astype(np.uint8))
        px = np.stack(px)
        cfg = CodecConfig(quality=50)
        fused = np.asarray(
            transform.encode_blocks(jnp.asarray(px.reshape(-1, 64)), cfg)
        )
        _tie_tolerant_compare(oracle, px, fused, 50)


class TestRLEParity:
    def test_random_sparse_blocks(self, oracle):
        rng = np.random.default_rng(15)
        for density in (0.0, 0.05, 0.2, 0.5, 1.0):
            blocks = rng.integers(-300, 300, size=(32, 8, 8)).astype(np.int32)
            keep = rng.uniform(size=blocks.shape) < density
            blocks = blocks * keep
            zz_perm = tables.zigzag_permutation(8)
            zz = blocks.reshape(-1, 64)[:, zz_perm]
            got = rle.rle_encode(jnp.asarray(zz))
            counts = np.asarray(got.counts)
            values = np.asarray(got.values)
            runs = np.asarray(got.runs)
            for b in range(len(blocks)):
                want_v, want_r = oracle.rle_encode(blocks[b])
                assert counts[b] == len(want_v), f"block {b}"
                np.testing.assert_array_equal(values[b, : counts[b]], want_v)
                np.testing.assert_array_equal(runs[b, : counts[b]], want_r)

    def test_decode_roundtrip_vs_oracle(self, oracle):
        rng = np.random.default_rng(16)
        blocks = rng.integers(-50, 50, size=(16, 8, 8)).astype(np.int32)
        blocks *= rng.uniform(size=blocks.shape) < 0.15
        perm = tables.zigzag_permutation(8)
        zz = blocks.reshape(-1, 64)[:, perm]
        enc = rle.rle_encode(jnp.asarray(zz))
        dec = np.asarray(rle.rle_decode(enc, 64))
        np.testing.assert_array_equal(dec, zz)
        counts = np.asarray(enc.counts)
        for b in range(len(blocks)):
            want = oracle.rle_decode(
                np.asarray(enc.values)[b, : counts[b]],
                np.asarray(enc.runs)[b, : counts[b]],
                8,
            )
            np.testing.assert_array_equal(want, blocks[b])

    def test_all_zero_block(self, oracle):
        """All-zero block: exactly one symbol (0, 64) — entropy.c:230-234."""
        zz = jnp.zeros((1, 64), jnp.int32)
        got = rle.rle_encode(zz)
        assert int(got.counts[0]) == 1
        assert int(got.values[0, 0]) == 0
        want_v, want_r = oracle.rle_encode(np.zeros((8, 8), np.int32))
        assert len(want_v) == 1
        assert int(got.runs[0, 0]) == want_r[0]

    def test_golden_block_21_symbols(self, oracle, golden_block):
        """The golden block at q50 RLE-encodes to 21 symbols (BASELINE.md)."""
        cfg = CodecConfig(quality=50)
        zz = transform.encode_blocks(jnp.asarray(golden_block.reshape(1, 64)), cfg)
        got = rle.rle_encode(zz)
        assert int(got.counts[0]) == 21


class TestFullBlockPipeline:
    @pytest.mark.parametrize("adaptive", (False, True))
    def test_e2e_vs_oracle(self, oracle, golden_block, adaptive):
        """Full encode->decode vs oracle_block_pipeline: identical quantized
        coefficients; reconstruction matches within 1 gray level (float
        epilogue)."""
        cfg = CodecConfig(quality=50, adaptive=adaptive, compat_b1=not adaptive)
        px = jnp.asarray(golden_block.reshape(1, 64))
        var = quant.block_variance_flat(transform.level_shift(px)) if adaptive else None
        zz = transform.encode_blocks(px, cfg, block_variance=var)
        want_zz, want_recon, want_bits, want_count = oracle.block_pipeline(
            golden_block, 50, adaptive=adaptive
        )
        np.testing.assert_array_equal(np.asarray(zz)[0], want_zz)
        rec = np.asarray(
            transform.decode_blocks(zz, cfg, block_variance=var)
        ).reshape(8, 8)
        assert np.abs(rec.astype(int) - want_recon.astype(int)).max() <= 1
