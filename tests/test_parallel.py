"""Sharded-encode tests on the 8-virtual-device CPU mesh.

The determinism tests are the codec's "race detector" (SURVEY.md section
5.2): identical bits regardless of mesh shape."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dct_tpu.config import CodecConfig
from dct_tpu.models import codec
from dct_tpu.parallel import mesh as meshlib
from dct_tpu.parallel import shard_encode
from dct_tpu.utils import image_io

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def photo():
    # 128 rows = 16 block rows = 16 stripes at stripe_rows=1
    return image_io.synthetic_image(128, 96, "photo", seed=9)


class TestMesh:
    def test_make_mesh_shapes(self):
        m = meshlib.make_mesh()
        assert m.shape == {"data": 1, "stripe": 8}
        m2 = meshlib.make_mesh(n_data=2)
        assert m2.shape == {"data": 2, "stripe": 4}
        m4 = meshlib.make_mesh(n_data=4, n_stripe=2)
        assert m4.shape == {"data": 4, "stripe": 2}


class TestOffsets:
    def test_stripe_byte_offsets(self):
        mesh = meshlib.make_mesh()
        bits = jnp.asarray([9, 16, 0, 7, 32, 100, 1, 8], jnp.int32)
        offs = np.asarray(shard_encode.stripe_byte_offsets(bits, mesh))
        nbytes = (np.asarray(bits) + 7) // 8
        want = np.cumsum(nbytes) - nbytes
        np.testing.assert_array_equal(offs, want)


class TestDeterminism:
    @pytest.mark.parametrize("adaptive", (False, True))
    def test_sharded_equals_single_device(self, photo, adaptive):
        """8-way stripe-sharded container == single-device container,
        byte for byte."""
        cfg = CodecConfig(quality=50, adaptive=adaptive)
        single = codec.encode(photo, cfg)
        mesh = meshlib.make_mesh()  # 1 x 8
        sharded = shard_encode.encode_image_sharded(photo, cfg, mesh)
        assert sharded == single

    def test_direct_mode_sharded_nondivisible(self):
        """Direct-mode value histograms must also mask mesh-pad stripes or
        the per-image table (and the container) depends on the mesh."""
        img = image_io.synthetic_image(120, 96, "photo", seed=3)  # 15 stripes
        cfg = CodecConfig(quality=50, huffman_mode="direct")
        single = codec.encode(img, cfg)
        for n in (2, 4, 8):
            mesh = meshlib.make_mesh(
                n_data=1, n_stripe=n, devices=jax.devices()[:n]
            )
            assert shard_encode.encode_image_sharded(img, cfg, mesh) == single

    @pytest.mark.parametrize("adaptive", (False, True))
    @pytest.mark.parametrize("static", (False, True))
    def test_sharded_equals_single_nondivisible(self, adaptive, static):
        """15 stripes over 2/4/8 devices (mesh padding in play): containers
        must still match the single-device encoder byte for byte —
        regression for pad-stripe variance codes leaking into the payload."""
        img = image_io.synthetic_image(120, 96, "photo", seed=3)
        cfg = CodecConfig(quality=50, adaptive=adaptive, static_tables=static)
        single = codec.encode(img, cfg)
        for n in (2, 4, 8):
            mesh = meshlib.make_mesh(
                n_data=1, n_stripe=n, devices=jax.devices()[:n]
            )
            assert shard_encode.encode_image_sharded(img, cfg, mesh) == single

    def test_mesh_shapes_agree(self, photo):
        """2-way vs 4-way vs 8-way stripe sharding: identical bytes."""
        cfg = CodecConfig(quality=75)
        outs = []
        for n in (2, 4, 8):
            mesh = meshlib.make_mesh(
                n_data=1, n_stripe=n, devices=jax.devices()[:n]
            )
            outs.append(shard_encode.encode_image_sharded(photo, cfg, mesh))
        assert outs[0] == outs[1] == outs[2]

    def test_static_tables_sharded(self, photo):
        cfg = CodecConfig(quality=50, static_tables=True)
        single = codec.encode(photo, cfg)
        mesh = meshlib.make_mesh()
        sharded = shard_encode.encode_image_sharded(photo, cfg, mesh)
        assert sharded == single
        # and it still decodes
        rec = codec.decode(sharded)
        assert rec.shape == photo.shape

    def test_sharded_decodes_correctly(self, photo):
        cfg = CodecConfig(quality=90, adaptive=True)
        mesh = meshlib.make_mesh(n_data=2)  # 2 x 4: stripes on 4 devices
        data = shard_encode.encode_image_sharded(photo, cfg, mesh)
        rec = codec.decode(data)
        from dct_tpu.utils import metrics

        assert metrics.psnr(rec, photo) >= 33


class TestBatchStep:
    def test_encode_batch_step(self):
        """dp x sp sharded batch step: runs, and per-frame payloads match
        the single-device static encoder's."""
        cfg = CodecConfig(quality=50, static_tables=True)
        frames = np.stack(
            [image_io.synthetic_image(64, 64, "photo", seed=s) for s in range(4)]
        )
        mesh = meshlib.make_mesh(n_data=2, n_stripe=4)
        n_stripes = 8  # 64/8 block rows
        packed = shard_encode.encode_batch_step(
            jnp.asarray(frames), cfg, n_stripes, mesh
        )
        assert packed.units.shape[0] == 4
        assert packed.bit_lengths.shape == (4, n_stripes)
        from dct_tpu.ops import bitstream as bs

        for f in range(4):
            single = codec.encode_step(jnp.asarray(frames[f]), cfg, n_stripes)[0]
            np.testing.assert_array_equal(
                np.asarray(packed.bit_lengths)[f], np.asarray(single.bit_lengths)
            )
            got = bs.stripes_to_bytes(
                bs.PackedStripes(packed.units[f], packed.bit_lengths[f])
            )
            want = bs.stripes_to_bytes(single)
            assert got == want


class TestShardedDecode:
    @pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
    def test_sharded_decode_matches_single(self, n_dev):
        import jax

        from dct_tpu.models import codec
        from dct_tpu.parallel import mesh as meshlib
        from dct_tpu.parallel import shard_encode
        from dct_tpu.utils import image_io

        img = image_io.synthetic_image(88, 112, "photo", seed=6)
        cfg = CodecConfig(quality=55, adaptive=True, stripe_rows=1)
        data = codec.ImageCodec(cfg).encode(img)
        want = codec.ImageCodec(cfg).decode(data)

        mesh = meshlib.make_mesh(
            n_data=1, n_stripe=n_dev, devices=jax.devices()[:n_dev]
        )
        got = np.asarray(shard_encode.decode_image_sharded(data, mesh))
        np.testing.assert_array_equal(got, want)


class TestShardedColor:
    @pytest.mark.parametrize("chroma", ["444", "420"])
    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_color_sharded_equals_single(self, chroma, n_dev):
        """Color containers: per-plane stripe sharding must be byte-
        identical to ColorImageCodec (includes mesh padding: the 420
        chroma grids have ~half the stripes of the luma grid)."""
        from dct_tpu.models.color import ColorImageCodec
        from dct_tpu.utils import image_io

        g = image_io.synthetic_image(104, 88, "photo", seed=11)
        rgb = np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)], -1)
        cfg = CodecConfig(quality=60, adaptive=True, chroma=chroma)
        single = ColorImageCodec(cfg).encode(rgb)
        mesh = meshlib.make_mesh(
            n_data=1, n_stripe=n_dev, devices=jax.devices()[:n_dev]
        )
        assert shard_encode.encode_image_sharded(rgb, cfg, mesh) == single

    @pytest.mark.parametrize("chroma", ["444", "420"])
    def test_color_sharded_decode_matches_single(self, chroma):
        from dct_tpu.models.color import ColorImageCodec
        from dct_tpu.utils import image_io

        g = image_io.synthetic_image(104, 88, "photo", seed=12)
        rgb = np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)], -1)
        cfg = CodecConfig(quality=60, chroma=chroma, coded_runs=True)
        data = ColorImageCodec(cfg).encode(rgb)
        want = ColorImageCodec(cfg).decode(data)
        mesh = meshlib.make_mesh(n_data=1, n_stripe=4, devices=jax.devices()[:4])
        got = np.asarray(shard_encode.decode_image_sharded(data, mesh))
        np.testing.assert_array_equal(got, want)


class TestShardedCodedRuns:
    @pytest.mark.parametrize("n_dev", [1, 4])
    @pytest.mark.parametrize("static", [True, False])
    def test_sharded_coded_runs_mesh_invariant(self, n_dev, static):
        from dct_tpu.utils import image_io

        img = image_io.synthetic_image(80, 96, "photo", seed=9)
        cfg = CodecConfig(quality=55, coded_runs=True, static_tables=static)
        want = codec.ImageCodec(cfg).encode(img)
        mesh = meshlib.make_mesh(
            n_data=1, n_stripe=n_dev, devices=jax.devices()[:n_dev]
        )
        got = shard_encode.encode_image_sharded(img, cfg, mesh)
        assert got == want  # byte-identical incl. the psum'd run table


class TestShardMapSteps:
    """The shard_map'd steps with jax's default check_vma=True: the
    static-table encode, the dp x sp batch step and the sharded
    reconstruct (host entropy decode, unindexed containers)."""

    def test_sharded_static_byte_identical(self, photo):
        cfg = CodecConfig(quality=50, static_tables=True)
        single = codec.encode(photo, cfg)
        mesh = meshlib.make_mesh()  # 1 x 8
        sharded = shard_encode.encode_image_sharded(photo, cfg, mesh)
        assert sharded == single

    def test_batch_step_two_frames(self):
        cfg = CodecConfig(quality=50, static_tables=True)
        frames = np.stack(
            [image_io.synthetic_image(64, 64, "photo", seed=s) for s in range(2)]
        )
        mesh = meshlib.make_mesh(n_data=2, n_stripe=4)
        packed = shard_encode.encode_batch_step(
            jnp.asarray(frames), cfg, 8, mesh
        )
        single = codec.encode_step(jnp.asarray(frames[0]), cfg, 8)[0]
        np.testing.assert_array_equal(
            np.asarray(packed.bit_lengths)[0], np.asarray(single.bit_lengths)
        )

    def test_batch_step_nondivisible_raises(self):
        cfg = CodecConfig(quality=50, static_tables=True)
        frames = np.stack(
            [image_io.synthetic_image(64, 64, "photo", seed=s) for s in range(2)]
        )
        mesh = meshlib.make_mesh(n_data=2, n_stripe=4)
        with pytest.raises(ValueError, match="stripe axis"):
            shard_encode.encode_batch_step(
                jnp.asarray(frames), cfg, 6, mesh
            )

    def test_sharded_decode_unindexed_roundtrip(self, photo):
        """An unindexed container: host entropy decode, then the sharded
        reconstruct must match the single-device decoder exactly."""
        cfg = CodecConfig(quality=50, static_tables=True, decode_index=False)
        mesh = meshlib.make_mesh()
        blob = shard_encode.encode_image_sharded(photo, cfg, mesh)
        rec = np.asarray(shard_encode.decode_image_sharded(blob, mesh))
        np.testing.assert_array_equal(rec, codec.decode(blob))

    def test_sharded_decode_unindexed_adaptive_color(self):
        """Adaptive (per-block scale through shard_map) + color planes."""
        cfg = CodecConfig(
            quality=50, adaptive=True, chroma="420", decode_index=False,
        )
        base = image_io.synthetic_image(128, 96, "photo", seed=4)
        rgb = np.stack(
            [np.clip(base.astype(np.int32) + d, 0, 255).astype(np.uint8)
             for d in (-20, 0, 25)], axis=-1,
        )
        mesh = meshlib.make_mesh()
        blob = shard_encode.encode_image_sharded(rgb, cfg, mesh)
        rec = np.asarray(shard_encode.decode_image_sharded(blob, mesh))
        from dct_tpu.models import color as _color
        want = np.asarray(_color.ColorImageCodec(cfg).decode(blob))
        np.testing.assert_array_equal(rec, want)


class TestShardedDeviceDecode:
    """Sharded DEVICE entropy decode: container-v2 planes decode with the
    lax entropy decoder under shard_map (zero collectives — stripes are
    independent substreams), byte-identical to the host decoders for
    every mesh shape, including meshes the stripe count doesn't divide
    (mesh-pad stripes are zero-length blocks)."""

    @staticmethod
    def _spy_device_path(monkeypatch):
        """The sharded device decode must actually RUN (not fall back to
        the host path, which would make the identity check vacuous)."""
        called = []
        orig = shard_encode._device_decode_step_sharded

        def spy(*a, **k):
            called.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(
            shard_encode, "_device_decode_step_sharded", spy
        )
        return called

    @pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
    def test_identical_across_meshes(self, n_dev, monkeypatch):
        im = np.asarray(image_io.synthetic_image(48, 64, "photo", seed=9))
        cfg = CodecConfig(
            quality=45, decode_index=True, adaptive=True,
            coded_runs=True, dc_prediction=True,
        )
        data = codec.ImageCodec(cfg).encode(im)
        host = codec.ImageCodec(cfg).decode(data)  # host entropy decode
        called = self._spy_device_path(monkeypatch)
        mesh = meshlib.make_mesh(devices=jax.devices()[:n_dev])
        dev = np.asarray(shard_encode.decode_image_sharded(data, mesh))
        assert called, "sharded decode never took the device entropy path"
        np.testing.assert_array_equal(host, dev)

    def test_color_indexed(self, monkeypatch):
        cfg = CodecConfig(quality=50, decode_index=True, chroma="420")
        base = image_io.synthetic_image(64, 48, "photo", seed=2)
        rgb = np.stack(
            [np.clip(base.astype(np.int32) + d, 0, 255).astype(np.uint8)
             for d in (-20, 0, 25)], axis=-1,
        )
        from dct_tpu.models import color as _color

        blob = _color.ColorImageCodec(cfg).encode(rgb)
        host = np.asarray(_color.ColorImageCodec(cfg).decode(blob))
        called = self._spy_device_path(monkeypatch)
        mesh = meshlib.make_mesh()
        dev = np.asarray(shard_encode.decode_image_sharded(blob, mesh))
        assert len(called) == 3, "expected all three planes on device"
        np.testing.assert_array_equal(host, dev)
