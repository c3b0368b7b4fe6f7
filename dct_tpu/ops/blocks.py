"""Image <-> macroblock tiling.

The reference only ever hints at this layer: create_block_from_pixels
(dct.c:109-120) gathers one N x N block from a row-major image but is never
called by any test; the image-level loop is unwritten (SURVEY.md section
3.5). On the device the "loop" is a reshape/transpose: (H, W) -> (H/N * W/N, N^2)
macroblock rows, with edge padding by replication (JPEG convention) so
partial tiles transform cleanly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pad_to_blocks(image: jax.Array, n: int) -> jax.Array:
    """Pad (H, W) up to multiples of n by edge replication."""
    h, w = image.shape[-2], image.shape[-1]
    ph = (-h) % n
    pw = (-w) % n
    if ph == 0 and pw == 0:
        return image
    pad = [(0, 0)] * (image.ndim - 2) + [(0, ph), (0, pw)]
    return jnp.pad(image, pad, mode="edge")


def image_to_blocks(image: jax.Array, n: int) -> jax.Array:
    """(..., H, W) -> (..., H/n * W/n, n*n) row-major flattened blocks.

    Blocks are ordered raster-scan (block-row major), matching the stripe
    layout: stripe s covers block rows [s*stripe_rows, (s+1)*stripe_rows).
    """
    x = pad_to_blocks(image, n)
    *lead, h, w = x.shape
    bh, bw = h // n, w // n
    x = x.reshape(*lead, bh, n, bw, n)
    x = jnp.swapaxes(x, -3, -2)  # (..., bh, bw, n, n)
    return x.reshape(*lead, bh * bw, n * n)


def blocks_to_image(blocks: jax.Array, h: int, w: int, n: int) -> jax.Array:
    """Inverse of image_to_blocks; crops padding back to (h, w)."""
    *lead, nb, n2 = blocks.shape
    ph, pw = h + (-h) % n, w + (-w) % n
    bh, bw = ph // n, pw // n
    x = blocks.reshape(*lead, bh, bw, n, n)
    x = jnp.swapaxes(x, -3, -2)
    x = x.reshape(*lead, ph, pw)
    return x[..., :h, :w]


def blocks_grid(h: int, w: int, n: int) -> tuple[int, int]:
    """(block rows, block cols) after padding."""
    return ((h + n - 1) // n, (w + n - 1) // n)
