"""DC prediction mode (cfg.dc_prediction): stripe-local DC DPCM.

The reference codes every block's DC coefficient raw (entropy.c writes the
full symbol stream with no prediction); neighbouring blocks' DCs are highly
correlated on natural images, so delta-coding them against the previous
block in the stripe shrinks the DC field (JPEG's DC prediction, restricted
to stripe scope so per-stripe independence — recovery, sharding — holds).

Contracts pinned here:
  * dc_predict / dc_reconstruct are exact inverses in the integer domain;
  * reconstructions are bit-identical to the unpredicted pipeline (the
    DPCM happens strictly between quantization and entropy coding);
  * containers get strictly smaller on photo content;
  * the flag survives the wire format;
  * sharded encode stays byte-identical to single-device for every mesh;
  * sharded decode, recovery (verify/repair/region decode), and video all
    invert the prediction;
  * the device packer writes the DPCM deltas byte-identically to the
    host reference packer (test_device_packer.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dct_tpu.config import CodecConfig
from dct_tpu.models import codec, recovery
from dct_tpu.utils import image_io


@pytest.fixture(scope="module")
def image():
    return image_io.synthetic_image(120, 168, "photo", seed=21)


@pytest.mark.parametrize("n_stripes", [1, 3, 8])
def test_predict_reconstruct_inverse(n_stripes):
    rng = np.random.default_rng(7)
    nb = 24 * n_stripes
    zz = rng.integers(-2048, 2048, size=(nb, 64)).astype(np.int32)
    pred = np.asarray(codec.dc_predict(jnp.asarray(zz), n_stripes))
    # AC coefficients untouched
    np.testing.assert_array_equal(pred[:, 1:], zz[:, 1:])
    # first block of each stripe raw: prediction is stripe-local
    bps = nb // n_stripes
    np.testing.assert_array_equal(pred[::bps, 0], zz[::bps, 0])
    # numpy and jax reconstruct paths both invert exactly
    np.testing.assert_array_equal(codec.dc_reconstruct(pred, n_stripes), zz)
    np.testing.assert_array_equal(
        np.asarray(codec.dc_reconstruct(jnp.asarray(pred), n_stripes)), zz
    )


@pytest.mark.parametrize("mode", ["category", "direct", "none"])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("coded_runs", [False, True])
def test_roundtrip_identical_and_smaller(image, mode, static, coded_runs):
    if static and mode != "category":
        pytest.skip("static tables are category-only")
    base_cfg = CodecConfig(
        quality=55, use_huffman=mode != "none", huffman_mode=mode,
        static_tables=static, coded_runs=coded_runs,
    )
    dc_cfg = base_cfg.replace(dc_prediction=True)
    base = codec.ImageCodec(base_cfg).encode(image)
    dc = codec.ImageCodec(dc_cfg).encode(image)
    rec_base = codec.ImageCodec(base_cfg).decode(base)
    rec_dc = codec.ImageCodec(dc_cfg).decode(dc)
    # DPCM sits between quantization and entropy coding: bit-identical pixels
    np.testing.assert_array_equal(rec_dc, rec_base)
    if mode != "none":
        # photo content: correlated DCs, delta field strictly cheaper
        assert len(dc) < len(base)


def test_adaptive_roundtrip(image):
    cfg = CodecConfig(quality=55, adaptive=True, dc_prediction=True)
    data = codec.ImageCodec(cfg).encode(image)
    rec = codec.ImageCodec(cfg).decode(data)
    want = codec.ImageCodec(cfg.replace(dc_prediction=False)).decode(
        codec.ImageCodec(cfg.replace(dc_prediction=False)).encode(image)
    )
    np.testing.assert_array_equal(rec, want)


def test_flag_survives_wire_format(image):
    from dct_tpu import container as cont

    cfg = CodecConfig(quality=50, dc_prediction=True, coded_runs=True)
    data = codec.ImageCodec(cfg).encode(image)
    c = cont.deserialize(data)
    assert c.config.dc_prediction
    assert c.config.coded_runs


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("static", [False, True])
def test_sharded_encode_byte_identical(image, n_dev, static):
    from dct_tpu.parallel import mesh as meshlib
    from dct_tpu.parallel import shard_encode

    cfg = CodecConfig(
        quality=55, dc_prediction=True, coded_runs=True, static_tables=static
    )
    want = codec.ImageCodec(cfg).encode(image)
    mesh = meshlib.make_mesh(
        n_data=1, n_stripe=n_dev, devices=jax.devices()[:n_dev]
    )
    got = shard_encode.encode_image_sharded(image, cfg, mesh)
    assert got == want


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_decode_matches_single(image, n_dev):
    from dct_tpu.parallel import mesh as meshlib
    from dct_tpu.parallel import shard_encode

    cfg = CodecConfig(quality=55, dc_prediction=True, adaptive=True)
    data = codec.ImageCodec(cfg).encode(image)
    want = codec.ImageCodec(cfg).decode(data)
    mesh = meshlib.make_mesh(
        n_data=1, n_stripe=n_dev, devices=jax.devices()[:n_dev]
    )
    got = np.asarray(shard_encode.decode_image_sharded(data, mesh))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_decode_coded_runs(image, n_dev):
    """decode_image_sharded must thread the stored run table through the
    entropy decoder (regression: it used to decode runs as flat 8 bits)."""
    from dct_tpu.parallel import mesh as meshlib
    from dct_tpu.parallel import shard_encode

    cfg = CodecConfig(quality=55, coded_runs=True)
    data = codec.ImageCodec(cfg).encode(image)
    want = codec.ImageCodec(cfg).decode(data)
    mesh = meshlib.make_mesh(
        n_data=1, n_stripe=n_dev, devices=jax.devices()[:n_dev]
    )
    got = np.asarray(shard_encode.decode_image_sharded(data, mesh))
    np.testing.assert_array_equal(got, want)


def test_recovery_verify_repair(image):
    cfg = CodecConfig(quality=55, dc_prediction=True, stripe_rows=2)
    original = codec.ImageCodec(cfg).encode(image)
    assert recovery.verify(original) == []
    raw = bytearray(original)
    raw[-20:-12] = b"\x5a" * 8
    assert recovery.verify(bytes(raw))
    repaired = recovery.repair(bytes(raw), image)
    assert repaired == original


def test_recovery_decode_region(image):
    cfg = CodecConfig(quality=55, dc_prediction=True, stripe_rows=1)
    data = codec.ImageCodec(cfg).encode(image)
    full = codec.ImageCodec(cfg).decode(data)
    for row0, row1 in [(0, 16), (40, 96), (64, 120)]:
        region = recovery.decode_region(data, row0, row1)
        np.testing.assert_array_equal(region, full[row0:row1])


def test_video_roundtrip(image):
    from dct_tpu.models.video import VideoCodec

    frames = np.stack([image, image[::-1]])
    cfg = CodecConfig(quality=60, dc_prediction=True)
    streams = VideoCodec(cfg).encode(frames)
    want = VideoCodec(CodecConfig(quality=60)).decode(
        VideoCodec(CodecConfig(quality=60)).encode(frames)
    )
    np.testing.assert_array_equal(VideoCodec(cfg).decode(streams), want)
