"""Color codec: RGB <-> YCbCr, chroma subsampling, multi-plane container.

The reference is implicitly grayscale (single plane everywhere; SURVEY.md
section 1). This model family extends the same pipeline to color per
BASELINE.json config 3: per-plane DCT+quant with 4:4:4 or 4:2:0 chroma,
using the standard JPEG chrominance quant table for Cb/Cr
(tables.JPEG_CHROMA_QUANT).

Color conversion is BT.601 full-range (the JFIF convention): elementwise
work fused by XLA into the tiling reshapes around it; the forward
conversion is 16-bit fixed point so containers do not depend on the
device that encoded them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dct_tpu import container as cont
from dct_tpu.config import CodecConfig
from dct_tpu.models import codec as _codec


# BT.601 full-range (JFIF) RGB -> YCbCr in 16-bit fixed point, as libjpeg's
# jccolor.c does it: integer arithmetic gives identical planes on every
# backend, where float products and sums (contracted into FMAs or summed
# in another order by the GPU compiler) moved pixels across rounding
# boundaries and changed the encoded bytes. Each row sums to 65536 (Y) or
# 0 (Cb, Cr), so gray input has neutral chroma exactly.
_Y_FIX = (19595, 38470, 7471)
_CB_FIX = (-11058, -21710, 32768)
_CR_FIX = (32768, -27439, -5329)


def _fixed_dot(rgb: jax.Array, coef) -> jax.Array:
    """(H, W, 3) u8 -> (H, W) int32 sum of coef * channel (2^16 scale)."""
    x = rgb.astype(jnp.int32)
    return coef[0] * x[..., 0] + coef[1] * x[..., 1] + coef[2] * x[..., 2]


def _sum_2x2(plane: jax.Array) -> jax.Array:
    """2x2 box sum (edge-replicated for odd dims): (H, W) ->
    (ceil(H/2), ceil(W/2)), exact in int32."""
    h, w = plane.shape
    ph, pw = h + (h & 1), w + (w & 1)
    x = jnp.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
    return x.reshape(ph // 2, 2, pw // 2, 2).sum(axis=(1, 3))


def _round_shift(x: jax.Array, shift: int, offset: int) -> jax.Array:
    """Fixed-point x / 2^shift + offset, rounded half up, clamped to u8."""
    y = (x + (offset << shift) + (1 << (shift - 1))) >> shift
    return jnp.clip(y, 0, 255).astype(jnp.uint8)


def ycbcr_to_rgb(ycc: jax.Array) -> jax.Array:
    """(H, W, 3) float YCbCr -> (H, W, 3) u8 RGB."""
    y = ycc[..., 0]
    cb = ycc[..., 1] - 128.0
    cr = ycc[..., 2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(jnp.round(rgb), 0, 255).astype(jnp.uint8)


def upsample_420(plane: jax.Array, h: int, w: int) -> jax.Array:
    """Nearest-neighbor 2x upsample back to (h, w)."""
    x = jnp.repeat(jnp.repeat(plane, 2, axis=0), 2, axis=1)
    return x[:h, :w]


def planes_to_rgb(
    y: jax.Array, cb: jax.Array, cr: jax.Array, mode: str, h: int, w: int
) -> jax.Array:
    """Decoded planes -> (h, w, 3) u8 RGB on device: chroma upsample
    (4:2:0) + YCbCr->RGB. The shared reconstruction tail of every color
    decoder (image, batched video, sharded) — keep them byte-identical by
    construction."""
    cb = cb.astype(jnp.float32)
    cr = cr.astype(jnp.float32)
    if mode == "420":
        cb = upsample_420(cb, h, w)
        cr = upsample_420(cr, h, w)
    return ycbcr_to_rgb(jnp.stack([y.astype(jnp.float32), cb, cr], axis=-1))


@functools.partial(jax.jit, static_argnames=("mode",))
def _to_planes(rgb: jax.Array, mode: str):
    """(H, W, 3) u8 RGB -> u8 (Y, Cb, Cr) planes; 4:2:0 chroma is the 2x2
    box mean (edge-replicated for odd dims), all in integer arithmetic."""
    y = _round_shift(_fixed_dot(rgb, _Y_FIX), 16, 0)
    cb = _fixed_dot(rgb, _CB_FIX)
    cr = _fixed_dot(rgb, _CR_FIX)
    shift = 16
    if mode == "420":
        cb, cr = _sum_2x2(cb), _sum_2x2(cr)
        shift = 18  # a sum of 4 samples
    return y, _round_shift(cb, shift, 128), _round_shift(cr, shift, 128)


class ColorImageCodec:
    """YCbCr multi-plane codec: chroma '444' or '420'."""

    def __init__(self, config: CodecConfig):
        if config.chroma not in ("444", "420"):
            raise ValueError("ColorImageCodec requires chroma '444' or '420'")
        self.config = config

    def encode(self, rgb: np.ndarray) -> bytes:
        if rgb.ndim != 3 or rgb.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) RGB, got {rgb.shape}")
        h, w = int(rgb.shape[0]), int(rgb.shape[1])
        y, cb, cr = _to_planes(jnp.asarray(rgb, jnp.uint8), self.config.chroma)
        planes = [
            _codec.encode_plane(np.asarray(y), self.config, chroma=False),
            _codec.encode_plane(np.asarray(cb), self.config, chroma=True),
            _codec.encode_plane(np.asarray(cr), self.config, chroma=True),
        ]
        return cont.serialize(
            cont.Container(config=self.config, width=w, height=h, planes=planes)
        )

    def decode(self, data: bytes) -> np.ndarray:
        """Decode to a host array; entropy decode runs on the host."""
        return np.asarray(
            self._decode(data, _codec._decode_plane_host_entropy)
        )

    def decode_to_device(self, data: bytes) -> jax.Array:
        """Decode with the RGB reconstruction left ON DEVICE (u8 jax
        array) — for on-device consumers; mirrors
        ImageCodec.decode_to_device: indexed containers entropy-decode on
        the device too. Dequant+IDCT per plane plus the chroma upsample and
        YCbCr->RGB run on device."""
        return self._decode(data, _codec.decode_plane_device)

    @staticmethod
    def _decode(data: bytes, decode_plane) -> jax.Array:
        c = cont.deserialize(data)
        cfg = c.config
        y = decode_plane(c.planes[0], cfg, chroma=False)
        cb = decode_plane(c.planes[1], cfg, chroma=True)
        cr = decode_plane(c.planes[2], cfg, chroma=True)
        return planes_to_rgb(y, cb, cr, cfg.chroma, c.height, c.width)
