"""Entropy-stage tests: Huffman tables, size-estimate parity with the C
reference, device scatter-packer vs host reference packer, native decoder."""

import numpy as np
import pytest

import jax.numpy as jnp

from dct_tpu.config import CodecConfig
from dct_tpu.ops import bitstream as bs
from dct_tpu.ops import huffman as hf
from dct_tpu.ops import rle, transform


def _random_symbols(rng, n_blocks, sparsity=0.15, lo=-300, hi=300):
    zz = rng.integers(lo, hi, size=(n_blocks, 64)).astype(np.int32)
    zz *= rng.uniform(size=zz.shape) < sparsity
    return rle.rle_encode(jnp.asarray(zz)), zz


class TestCategories:
    def test_category_of(self):
        v = jnp.asarray([0, 1, -1, 2, 3, -4, 7, 8, -255, 256, 1023, -1024])
        got = np.asarray(hf.category_of(v))
        np.testing.assert_array_equal(got, [0, 1, 1, 2, 2, 3, 3, 4, 8, 9, 10, 11])

    def test_extra_bits_roundtrip(self):
        vals = np.concatenate([np.arange(-1100, 1101)]).astype(np.int32)
        v = jnp.asarray(vals)
        cats = hf.category_of(v)
        extra = hf.category_extra_bits(v, cats)
        back = hf.value_from_category(np.asarray(cats), np.asarray(extra))
        np.testing.assert_array_equal(back, vals)


class TestHuffman:
    def test_lengths_kraft(self):
        rng = np.random.default_rng(0)
        for _ in range(20):
            freqs = rng.integers(0, 1000, size=rng.integers(2, 40))
            lengths = hf.huffman_code_lengths(freqs)
            k = sum(2.0 ** -l for l in lengths if l > 0)
            assert k <= 1.0 + 1e-9
            assert (lengths[freqs == 0] == 0).all()

    def test_canonical_prefix_free(self):
        freqs = np.array([50, 30, 10, 5, 3, 1, 1])
        t = hf.CanonicalTable.from_frequencies(freqs)
        codes = [
            format(int(t.codes[s]), f"0{int(t.lengths[s])}b")
            for s in range(len(freqs))
            if t.lengths[s] > 0
        ]
        for i, a in enumerate(codes):
            for j, b in enumerate(codes):
                if i != j:
                    assert not b.startswith(a)

    def test_length_limit(self):
        # fibonacci-like freqs force long codes; cap must hold
        freqs = np.array([1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233,
                          377, 610, 987, 1597, 2584, 4181, 6765])
        lengths = hf.huffman_code_lengths(freqs, max_len=10)
        assert lengths.max() <= 10
        k = sum(2.0 ** -l for l in lengths if l > 0)
        assert k <= 1.0 + 1e-9

    def test_single_symbol(self):
        lengths = hf.huffman_code_lengths(np.array([0, 7, 0]))
        np.testing.assert_array_equal(lengths, [0, 1, 0])

    def test_size_estimate_matches_oracle(self, oracle):
        """Reference get_encoded_size parity: Huffman totals are
        tie-invariant, so an independent coder must reproduce them exactly
        (entropy.c:363-399), including quirk B3."""
        rng = np.random.default_rng(1)
        for trial in range(30):
            sparsity = rng.uniform(0.02, 0.9)
            block = (
                rng.integers(-40, 40, size=(8, 8))
                * (rng.uniform(size=(8, 8)) < sparsity)
            ).astype(np.int32)
            values, runs = oracle.rle_encode(block)
            for use_huffman in (True, False):
                want = oracle.encoded_size(values, runs, use_huffman)
                got = hf.reference_encoded_size_bits(values, use_huffman)
                assert got == want, (
                    f"trial {trial} huffman={use_huffman}: {got} != {want}"
                )

    def test_size_estimate_b3_single_symbol(self, oracle):
        """All-zero block: one symbol, empty code -> 8 bits total."""
        values, runs = oracle.rle_encode(np.zeros((8, 8), np.int32))
        want = oracle.encoded_size(values, runs, True)
        got = hf.reference_encoded_size_bits(values, True)
        assert got == want == 8

    def test_golden_sizes(self, oracle, golden_block):
        """Golden block @ q50: 232-bit estimate (BASELINE.md)."""
        zz, _, bits, count = oracle.block_pipeline(golden_block, 50)
        assert bits == 232 and count == 21
        cfg = CodecConfig(quality=50)
        zz2 = transform.encode_blocks(jnp.asarray(golden_block.reshape(1, 64)), cfg)
        sym = rle.rle_encode(zz2)
        c = int(sym.counts[0])
        got = hf.reference_encoded_size_bits(np.asarray(sym.values)[0, :c])
        assert got == 232


class TestDevicePacker:
    @pytest.mark.parametrize("mode", ("category", "direct", "none"))
    def test_device_matches_host_packer(self, mode):
        """The device scatter packer must produce byte-identical streams to the
        sequential host BitWriter."""
        rng = np.random.default_rng(2)
        symbols, _ = _random_symbols(rng, 24)
        counts = np.asarray(symbols.counts)
        values = np.asarray(symbols.values)
        runs = np.asarray(symbols.runs)

        if mode == "category":
            hist = np.asarray(hf.category_histogram(symbols.values, symbols.counts))
            table = hf.CanonicalTable.from_frequencies(hist)
            cv, cl = bs.symbol_chunks(
                symbols, mode,
                cat_lengths=jnp.asarray(table.lengths),
                cat_codes=jnp.asarray(table.codes.astype(np.int64), jnp.uint32),
            )
        elif mode == "direct":
            hist = np.asarray(
                hf.value_histogram(symbols.values, symbols.counts, -255, 255)
            )
            table = hf.CanonicalTable.from_frequencies(hist)
            cv, cl = bs.symbol_chunks(
                symbols, mode,
                val_lengths=jnp.asarray(table.lengths),
                val_codes=jnp.asarray(table.codes.astype(np.int64), jnp.uint32),
                vmin=-255,
            )
        else:
            table = None
            cv, cl = bs.symbol_chunks(symbols, mode)

        # 4 stripes of 6 blocks
        cv = np.asarray(cv).reshape(4, 6 * 64, 3)
        cl = np.asarray(cl).reshape(4, 6 * 64, 3)
        packed = bs.pack_chunks(
            jnp.asarray(cv), jnp.asarray(cl), 6 * bs.UNITS_PER_BLOCK_WORST
        )
        device_bytes = bs.stripes_to_bytes(packed)

        per_stripe = []
        for s in range(4):
            vs, rs = [], []
            for b in range(s * 6, (s + 1) * 6):
                c = counts[b]
                vs.append(values[b, :c])
                rs.append(runs[b, :c])
            per_stripe.append((np.concatenate(vs), np.concatenate(rs)))
        host_bytes = bs.pack_stripes_host(
            per_stripe, mode,
            cat_table=table if mode == "category" else None,
            val_table=table if mode == "direct" else None,
            vmin=-255,
        )
        for s in range(4):
            assert device_bytes[s] == host_bytes[s], f"stripe {s} differs"

    @pytest.mark.parametrize("mode", ("category", "direct", "none"))
    def test_gather_packer_matches_scatter_packer(self, mode):
        """pack_chunks_gather (prefix-sum/searchsorted, scatter-free hot
        path) must be byte-identical to pack_chunks, in both compacted and
        positional symbol layouts."""
        rng = np.random.default_rng(7)
        zz = rng.integers(-300, 300, size=(24, 64)).astype(np.int32)
        zz *= rng.uniform(size=zz.shape) < 0.2
        compacted = rle.rle_encode(jnp.asarray(zz))
        positional = rle.rle_encode_positional(jnp.asarray(zz))

        kw = {}
        if mode == "category":
            hist = np.asarray(
                hf.category_histogram(compacted.values, compacted.counts)
            )
            t = hf.CanonicalTable.from_frequencies(hist)
            kw = dict(
                cat_lengths=jnp.asarray(t.lengths),
                cat_codes=jnp.asarray(t.codes.astype(np.int64), jnp.uint32),
            )
        elif mode == "direct":
            hist = np.asarray(
                hf.value_histogram(compacted.values, compacted.counts, -255, 255)
            )
            t = hf.CanonicalTable.from_frequencies(hist)
            kw = dict(
                val_lengths=jnp.asarray(t.lengths),
                val_codes=jnp.asarray(t.codes.astype(np.int64), jnp.uint32),
                vmin=-255,
            )

        outs = []
        for syms in (compacted, positional):
            cv, cl = bs.symbol_chunks(syms, mode, **kw)
            cv = jnp.asarray(np.asarray(cv).reshape(4, -1, 3))
            cl = jnp.asarray(np.asarray(cl).reshape(4, -1, 3))
            cap = 6 * bs.UNITS_PER_BLOCK_WORST
            outs.append(bs.stripes_to_bytes(bs.pack_chunks(cv, cl, cap)))
            outs.append(bs.stripes_to_bytes(bs.pack_chunks_gather(cv, cl, cap)))
        for other in outs[1:]:
            assert other == outs[0]

    def test_scatter_packer_matches_host_packer(self):
        """The device scatter packer is byte-identical to the host
        reference packer on a per-image table."""
        rng = np.random.default_rng(11)
        zz = rng.integers(-200, 200, size=(12, 64)).astype(np.int32)
        zz *= rng.uniform(size=zz.shape) < 0.3
        s = rle.rle_encode_positional(jnp.asarray(zz))
        hist = np.asarray(hf.category_histogram_masked(s.values, s.is_sym))
        t = hf.CanonicalTable.from_frequencies(hist)
        cv, cl = bs.symbol_chunks(
            s, "category",
            cat_lengths=jnp.asarray(t.lengths),
            cat_codes=jnp.asarray(t.codes.astype(np.int64), jnp.uint32),
        )
        cv = jnp.asarray(np.asarray(cv).reshape(3, -1, 3))
        cl = jnp.asarray(np.asarray(cl).reshape(3, -1, 3))
        cap = 4 * bs.UNITS_PER_BLOCK_WORST
        got = bs.stripes_to_bytes(bs.pack_chunks(cv, cl, cap))
        v, r, m = (np.asarray(x) for x in (s.values, s.runs, s.is_sym))
        want = bs.pack_stripes_host(
            [(v[i:i + 4][m[i:i + 4]], r[i:i + 4][m[i:i + 4]])
             for i in range(0, 12, 4)],
            "category", cat_table=t,
        )
        assert got == want

    def test_positional_histogram_matches_compacted(self):
        rng = np.random.default_rng(8)
        zz = rng.integers(-500, 500, size=(40, 64)).astype(np.int32)
        zz *= rng.uniform(size=zz.shape) < 0.3
        comp = rle.rle_encode(jnp.asarray(zz))
        pos = rle.rle_encode_positional(jnp.asarray(zz))
        h1 = np.asarray(hf.category_histogram(comp.values, comp.counts))
        h2 = np.asarray(hf.category_histogram_masked(pos.values, pos.is_sym))
        np.testing.assert_array_equal(h1, h2)

    def test_direct_mode_esc(self):
        """Values outside [-255, 255] must escape to raw 16-bit and decode
        back exactly."""
        zz = np.zeros((2, 64), np.int32)
        zz[0, 0] = 1000
        zz[0, 5] = -999
        zz[1, 0] = -256
        zz[1, 63] = 256
        symbols = rle.rle_encode(jnp.asarray(zz))
        hist = np.asarray(hf.value_histogram(symbols.values, symbols.counts, -255, 255))
        assert hist[-1] == 4  # all four escaped
        table = hf.CanonicalTable.from_frequencies(hist)
        cv, cl = bs.symbol_chunks(
            symbols, "direct",
            val_lengths=jnp.asarray(table.lengths),
            val_codes=jnp.asarray(table.codes.astype(np.int64), jnp.uint32),
            vmin=-255,
        )
        packed = bs.pack_chunks(
            jnp.asarray(np.asarray(cv).reshape(1, -1, 3)),
            jnp.asarray(np.asarray(cl).reshape(1, -1, 3)),
            2 * bs.UNITS_PER_BLOCK_WORST,
        )
        data = bs.stripes_to_bytes(packed)[0]
        out = bs.unpack_stripe_host(data, 2, 64, "direct", val_table=table, vmin=-255)
        np.testing.assert_array_equal(out, zz)

    @pytest.mark.parametrize("mode", ("category", "direct", "none"))
    def test_roundtrip_python_and_native(self, mode):
        """pack (device) -> unpack via BOTH the Python and native C++
        decoders; all three agree."""
        from dct_tpu import native

        rng = np.random.default_rng(3)
        symbols, zz = _random_symbols(rng, 12, sparsity=0.3)
        kw = {}
        table = None
        if mode == "category":
            hist = np.asarray(hf.category_histogram(symbols.values, symbols.counts))
            table = hf.CanonicalTable.from_frequencies(hist)
            kw = dict(
                cat_lengths=jnp.asarray(table.lengths),
                cat_codes=jnp.asarray(table.codes.astype(np.int64), jnp.uint32),
            )
        elif mode == "direct":
            hist = np.asarray(
                hf.value_histogram(symbols.values, symbols.counts, -255, 255)
            )
            table = hf.CanonicalTable.from_frequencies(hist)
            kw = dict(
                val_lengths=jnp.asarray(table.lengths),
                val_codes=jnp.asarray(table.codes.astype(np.int64), jnp.uint32),
                vmin=-255,
            )
        cv, cl = bs.symbol_chunks(symbols, mode, **kw)
        packed = bs.pack_chunks(
            jnp.asarray(np.asarray(cv).reshape(3, -1, 3)),
            jnp.asarray(np.asarray(cl).reshape(3, -1, 3)),
            4 * bs.UNITS_PER_BLOCK_WORST,
        )
        stripes = bs.stripes_to_bytes(packed)
        py = np.concatenate(
            [
                bs.unpack_stripe_host(
                    s, 4, 64, mode,
                    cat_table=table if mode == "category" else None,
                    val_table=table if mode == "direct" else None,
                    vmin=-255,
                )
                for s in stripes
            ]
        )
        np.testing.assert_array_equal(py, zz)
        if native.available():
            nat = native.unpack_stripes(stripes, 4, 64, mode, table, -255)
            np.testing.assert_array_equal(nat, zz)


class TestNativeAbiHandshake:
    def test_stale_library_falls_back(self, monkeypatch):
        """A prebuilt libdctbits.so from before an ABI change (e.g. v1's
        int32 unpack output vs v2's int16) must NOT bind — calling a v1
        library through the v2 signature would overflow the output
        buffer. _load must return None for both failure shapes: the
        version symbol missing entirely, and a version mismatch."""
        import ctypes as _ct

        from dct_tpu import native as nat

        class _NoSymbol:
            def __getattr__(self, name):
                raise AttributeError(name)

        class _VerFn:
            restype = None

            def __call__(self):
                return nat._ABI_VERSION - 1

        class _WrongVersion:
            dctbits_abi_version = _VerFn()

        for fake in (_NoSymbol(), _WrongVersion()):
            monkeypatch.setattr(nat, "_lib", None)
            monkeypatch.setattr(nat, "_build_failed", False)
            monkeypatch.setattr(_ct, "CDLL", lambda *a, **k: fake)
            assert nat._load() is None
            assert not nat.available()  # caches the failure

        # the real library binds again after the fakes are removed
        monkeypatch.undo()
        nat._lib = None
        nat._build_failed = False
        assert nat.available()
        assert nat._load().dctbits_abi_version() == nat._ABI_VERSION
