"""Device entropy decoder (ops/entropy_decode.py) + the container v2
decode index (cfg.decode_index).

Contracts:
  * the per-block bit index equals the staged chunk-length sums, and it
    sums to stripe_bits;
  * container v2 round-trips the index and rejects hostile ones;
  * decode_to_device (device entropy decoder for indexed containers)
    gives pixels IDENTICAL to decode() (host decoders) across the mode
    lattice and block sizes;
  * tables the device decoder cannot represent reach the host decoder;
  * repair keeps an indexed container consistent.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from dct_tpu import container as cont
from dct_tpu.config import CodecConfig
from dct_tpu.models import codec
from dct_tpu.utils import image_io


@pytest.fixture
def device_path(monkeypatch):
    """Counts device entropy decodes, so an identity check against the
    host decoder cannot pass vacuously through a host fallback."""
    calls = []
    orig = codec._device_decode_step

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(codec, "_device_decode_step", spy)
    return calls


def _host_and_device(im, cfg):
    data = codec.ImageCodec(cfg).encode(np.asarray(im))
    host = codec.ImageCodec(cfg).decode(data)
    dev = np.asarray(codec.ImageCodec(cfg).decode_to_device(data))
    return host, dev


@pytest.mark.parametrize(
    "mode,runs,dc,adaptive",
    [
        ("category", False, False, False),
        ("category", True, True, True),
        ("direct", False, False, False),
        ("direct", True, False, True),
        ("none", False, True, False),
        ("none", True, False, False),
    ],
)
def test_device_decode_matches_host(device_path, mode, runs, dc, adaptive):
    im = image_io.synthetic_image(40, 72, "photo", seed=3)
    cfg = CodecConfig(
        quality=40, huffman_mode=mode, coded_runs=runs, dc_prediction=dc,
        adaptive=adaptive, decode_index=True,
    )
    host, dev = _host_and_device(im, cfg)
    assert device_path
    np.testing.assert_array_equal(host, dev)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_device_decode_block_sizes(device_path, n):
    im = image_io.synthetic_image(3 * n, 7 * n + 3, "photo", seed=n)
    cfg = CodecConfig(
        block_size=n, quality=40, decode_index=True, coded_runs=n <= 8,
    )
    host, dev = _host_and_device(im, cfg)
    assert device_path
    np.testing.assert_array_equal(host, dev)


def test_device_decode_wide_image_multichunk(device_path):
    """Stripes of 256 blocks (2048 px): every block's cursor starts deep
    into its stripe's words (regression guard from the previous decoder,
    which mis-addressed blocks past the first 128 of a stripe)."""
    im = image_io.synthetic_image(16, 2048, "photo", seed=0)
    cfg = CodecConfig(quality=50, decode_index=True)
    host, dev = _host_and_device(im, cfg)
    assert device_path
    np.testing.assert_array_equal(host, dev)


def test_block_bits_match_staged_chunk_lengths():
    """encode_pack's per-block bit index == the staged chunk-length sums,
    and it sums to the stripe bit lengths."""
    from dct_tpu.ops import blocks as blk
    from dct_tpu.ops import huffman as hf
    from dct_tpu.ops import rle, transform

    cfg = CodecConfig(quality=50, static_tables=True)
    rng = np.random.default_rng(1)
    im = rng.integers(0, 256, (32, 64)).astype(np.uint8)
    px = blk.image_to_blocks(jnp.asarray(im), 8)
    lengths, codes = codec._table_arrays(hf.default_category_table(50))
    zz = transform.encode_blocks(px, cfg)
    sym = rle.rle_encode_positional(zz)
    packed, bb = codec.encode_pack(
        sym, cfg, 4, lengths, codes, return_block_bits=True
    )
    _, cl = codec.symbol_chunks_for(sym, cfg, lengths, codes)
    want = np.asarray(jnp.sum(cl, axis=(1, 2))).reshape(4, -1)
    np.testing.assert_array_equal(np.asarray(bb), want)
    np.testing.assert_array_equal(
        np.asarray(bb).sum(1), np.asarray(packed.bit_lengths)
    )


def test_container_v2_roundtrip_and_hostile():
    im = image_io.synthetic_image(33, 61, "photo", seed=0)
    cfg = CodecConfig(quality=50, decode_index=True)
    data = codec.ImageCodec(cfg).encode(np.asarray(im))
    c = cont.deserialize(data)
    assert c.config.decode_index
    p = c.planes[0]
    assert int(p.block_bits.sum()) == int(p.stripe_bits.sum())

    # v1 containers stay readable and carry no index
    d0 = codec.ImageCodec(cfg.replace(decode_index=False)).encode(
        np.asarray(im)
    )
    assert cont.deserialize(d0).planes[0].block_bits is None
    # the index costs exactly flags2 + width byte + the bit-packed
    # entries at the narrowest per-plane width
    w_idx, packed_idx = cont.pack_index(p.block_bits)
    assert len(data) == len(d0) + 1 + 1 + len(packed_idx)
    assert w_idx == int(p.block_bits.max()).bit_length()

    # hostile index: corrupt one entry -> stripe-sum check rejects
    bad = bytearray(data)
    # the index sits right before the payload; find it by re-serializing
    # with a poked block_bits instead of byte surgery
    p_bad = cont.PlaneData(
        width=p.width, height=p.height, table_lengths=p.table_lengths,
        vmin=p.vmin, variance_codes=p.variance_codes,
        stripe_bits=p.stripe_bits, stripes=p.stripes,
        run_table_lengths=p.run_table_lengths,
        block_bits=p.block_bits.copy(),
    )
    p_bad.block_bits[0] += 8
    with pytest.raises(ValueError):
        cont.serialize(
            cont.Container(
                config=c.config, width=c.width, height=c.height,
                planes=[p_bad],
            )
        )
    # same corruption on the wire -> deserialize rejects
    idx_off = data.index(packed_idx)
    bad = bytearray(data)
    bad[idx_off] ^= 0x08
    with pytest.raises(ValueError):
        cont.deserialize(bytes(bad))

    # unknown extension flag bits are rejected, not ignored
    bad2 = bytearray(data)
    bad2[20] |= 0x04
    with pytest.raises(ValueError):
        cont.deserialize(bytes(bad2))

    # legacy round-4 v2 (raw u16 index, flags2 bit0 only) stays readable
    legacy = bytearray(d0)
    legacy[4] = 2  # version
    legacy[20:20] = bytes([1])  # insert flags2: index present, unpacked
    # the index sits right after this plane's stripe_bits table
    p_legacy = cont.deserialize(d0).planes[0]
    sb_off = len(legacy) - sum(len(s) for s in p_legacy.stripes)
    legacy[sb_off:sb_off] = p.block_bits.astype("<u2").tobytes()
    c_legacy = cont.deserialize(bytes(legacy))
    np.testing.assert_array_equal(
        c_legacy.planes[0].block_bits, p.block_bits
    )


def test_repair_updates_decode_index(device_path):
    from dct_tpu.models import recovery

    im = image_io.synthetic_image(48, 64, "photo", seed=5)
    cfg = CodecConfig(quality=50, decode_index=True)
    data = codec.ImageCodec(cfg).encode(np.asarray(im))
    c = cont.deserialize(data)
    # corrupt stripe 2's payload, then repair from the source image
    p = c.planes[0]
    stripes = list(p.stripes)
    stripes[2] = bytes([b ^ 0xFF for b in stripes[2]])
    c.planes[0] = cont.PlaneData(
        width=p.width, height=p.height, table_lengths=p.table_lengths,
        vmin=p.vmin, variance_codes=p.variance_codes,
        stripe_bits=p.stripe_bits, stripes=stripes,
        run_table_lengths=p.run_table_lengths, block_bits=p.block_bits,
    )
    # grayscale containers address stripes by FLAT index (recovery.repair)
    fixed = recovery.repair(cont.serialize(c), np.asarray(im), [2])
    assert fixed == data  # byte-identical to a clean encode, index included
    dev = np.asarray(codec.ImageCodec(cfg).decode_to_device(fixed))
    host = codec.ImageCodec(cfg).decode(fixed)
    assert device_path
    np.testing.assert_array_equal(host, dev)


def test_unindexed_or_unsupported_falls_back_to_host(device_path):
    """No index -> host decoder. The device decoder's one format limit
    (tables_supported): codes over 16 bits, and direct alphabets outside
    int16, also go to the host decoder (end to end:
    test_long_code_table_decodes_on_host)."""
    from dct_tpu.ops import entropy_decode as ed
    from dct_tpu.ops import huffman as hf

    im = image_io.synthetic_image(24, 40, "photo", seed=1)
    cfg = CodecConfig(quality=50, decode_index=False)
    data = codec.ImageCodec(cfg).encode(np.asarray(im))
    out = np.asarray(codec.ImageCodec(cfg).decode_to_device(data))
    assert not device_path
    np.testing.assert_array_equal(out, codec.ImageCodec(cfg).decode(data))

    lengths = np.zeros(32, np.int32)
    lengths[:3] = [1, 17, 2]  # a 17-bit code
    assert not ed.tables_supported(hf.CanonicalTable(lengths), None)
    assert not ed.tables_supported(None, hf.CanonicalTable(lengths))
    ok = hf.default_category_table(50)
    assert ed.tables_supported(ok, hf.default_run_table(50))
    direct = hf.CanonicalTable(np.full(512, 9, np.int32))
    assert ed.tables_supported(direct, None, vmin=-255)
    assert not ed.tables_supported(direct, None, vmin=0x7F00)


def test_long_code_table_decodes_on_host(device_path):
    """An indexed container whose valid category table has a 17-bit code
    (never written by this encoder, legal on the wire) must take the host
    decoder from decode_to_device, and both routes give the same pixels
    as the container's standard-table twin."""
    from dct_tpu.ops import blocks as blk
    from dct_tpu.ops import bitstream as bs
    from dct_tpu.ops import huffman as hf
    from dct_tpu.ops import rle, transform

    im = np.asarray(image_io.synthetic_image(24, 40, "photo", seed=4))
    cfg = CodecConfig(quality=50, decode_index=True)
    # categories 0..14 get lengths 1..15, category 15 (unused by this
    # content) 17 bits: Kraft sum < 1, a valid canonical table
    lengths = np.array(list(range(1, 16)) + [17], np.int32)
    table = hf.CanonicalTable(lengths)
    img = codec.pad_plane_for_encode(im, cfg)
    zz = transform.encode_blocks(blk.image_to_blocks(img, 8), cfg)
    sym = rle.rle_encode_positional(zz)
    assert int(np.abs(np.asarray(zz)).max()) < 1 << 14  # no category 15
    n_stripes = img.shape[0] // 8
    packed, bb = codec.encode_pack(
        sym, cfg, n_stripes, *codec._table_arrays(table),
        return_block_bits=True,
    )
    packed = bs.fetch_packed(packed)
    plane = cont.PlaneData(
        width=im.shape[1], height=im.shape[0], table_lengths=lengths,
        vmin=codec.DIRECT_VMIN, variance_codes=None,
        stripe_bits=packed.bit_lengths.astype(np.uint32),
        stripes=bs.stripes_to_bytes(packed),
        block_bits=np.asarray(bb).reshape(-1).astype(np.uint16),
    )
    data = cont.serialize(cont.Container(
        config=cfg, width=im.shape[1], height=im.shape[0], planes=[plane],
    ))
    want = codec.ImageCodec(cfg).decode(codec.ImageCodec(cfg).encode(im))
    dev = np.asarray(codec.ImageCodec(cfg).decode_to_device(data))
    assert not device_path
    np.testing.assert_array_equal(dev, want)
    np.testing.assert_array_equal(codec.ImageCodec(cfg).decode(data), want)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(adaptive=True, coded_runs=True, dc_prediction=True),
        dict(huffman_mode="direct"),
    ],
    ids=["plain", "adaptive+runs+dc", "direct"],
)
def test_batched_video_device_decode(device_path, kw):
    """Indexed frame stacks decode in ONE batched device dispatch (the
    frames' stripes stacked along the decoder's stripe axis),
    pixel-identical to the host decoders."""
    from dct_tpu.models.video import VideoCodec

    frames = np.stack([
        np.asarray(image_io.synthetic_image(40, 64, "photo", seed=s))
        for s in range(4)
    ])
    cfg = CodecConfig(quality=45, decode_index=True, **kw)
    streams = VideoCodec(cfg).encode(frames)
    dev = np.asarray(VideoCodec(cfg).decode_to_device(streams))
    assert len(device_path) == 1
    host = np.stack([codec.decode(s) for s in streams])
    np.testing.assert_array_equal(dev, host)
