"""Batched 2D DCT / IDCT and the fused encode/decode front-ends.

Reference behavior being reimplemented (not translated):
  * forward DCT ``D @ X @ D.T`` — dct.c:52-74 (two N^3 loops per block)
  * inverse DCT ``D.T @ X @ D`` — dct.c:80-105
  * level shift -128 — dct.c:115; +128 and [0,255] clamp on decode —
    test_entropy.c:377-380
  * coefficient rounding — copy_block_to_coefficients, dct.c:123-129, which
    uses C ``round()`` = round-half-AWAY-from-zero (not banker's rounding).

Blocks are a batch axis, never a loop. Two paths:
  * ``dct2``/``idct2`` — einsum on (B, N, N), the always-correct float
    transform (used for float-domain tests and the public transform API).
  * ``encode_blocks``/``decode_blocks`` — the fused single-matmul path over
    (B, N^2) using the Kronecker operators from dct_tpu.tables; this is the
    production encode/decode front-end.

Decode matmuls run at ``jax.lax.Precision.HIGHEST`` (no TF32 on a GPU);
the encode matmul is three bf16 passes with f32 accumulation (see
split_operand_matmul). Both match the float64 C oracle after integer
rounding except at exact .5 ties (tests/test_parity.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dct_tpu.config import CodecConfig
from dct_tpu import tables

_PREC = jax.lax.Precision.HIGHEST


def round_half_away(x: jax.Array) -> jax.Array:
    """C ``round()`` semantics: round half away from zero.

    ``jnp.round`` rounds half to even; the reference rounds 0.5 -> 1,
    -0.5 -> -1 (dct.c:126, quantization.c:124). trunc(x +- 0.5) is
    bit-identical to the textbook sign(x)*floor(|x|+0.5) (negation is
    exact, so the magnitude add rounds the same way) in 4 vector ops
    instead of 6 — this sits in every encode/decode epilogue.
    """
    half = jnp.where(x >= 0, jnp.asarray(0.5, x.dtype), jnp.asarray(-0.5, x.dtype))
    return jnp.trunc(x + half)


def dct2(blocks: jax.Array, block_size: int | None = None) -> jax.Array:
    """Forward 2D DCT on a batch of blocks, shape (..., N, N).

    Equivalent to the reference's dct_forward (dct.c:52-74): D @ X @ D.T per
    block, but batched as one einsum (one matrix-unit contraction).
    """
    n = blocks.shape[-1] if block_size is None else block_size
    d = jnp.asarray(tables.dct_basis(n), dtype=blocks.dtype)
    return jnp.einsum("ik,...kl,jl->...ij", d, blocks, d, precision=_PREC)


def idct2(coeffs: jax.Array, block_size: int | None = None) -> jax.Array:
    """Inverse 2D DCT, shape (..., N, N): D.T @ Y @ D (dct.c:80-105)."""
    n = coeffs.shape[-1] if block_size is None else block_size
    d = jnp.asarray(tables.dct_basis(n), dtype=coeffs.dtype)
    return jnp.einsum("ki,...kl,lj->...ij", d, coeffs, d, precision=_PREC)


def level_shift(pixels: jax.Array, dtype=jnp.float32) -> jax.Array:
    """u8 pixels -> centered floats: x - 128 (dct.c:115)."""
    return pixels.astype(dtype) - jnp.asarray(128.0, dtype)


def level_unshift(x: jax.Array) -> jax.Array:
    """Centered floats -> u8 pixels: round(x) + 128 clamped to [0, 255]
    (test_entropy.c:377-380 clamps after +128)."""
    y = round_half_away(x) + 128.0
    return jnp.clip(y, 0.0, 255.0).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Fused single-matmul encode/decode front-ends
# ---------------------------------------------------------------------------


PACKED_N2 = (4, 16, 64)  # block sizes whose n2 divides the 128-wide row


def _block_diag(m: np.ndarray, copies: int) -> np.ndarray:
    """copies x copies block-diagonal tiling of m (n2 x n2) -> 128 x 128."""
    n2 = m.shape[0]
    out = np.zeros((copies * n2, copies * n2), m.dtype)
    for i in range(copies):
        out[i * n2 : (i + 1) * n2, i * n2 : (i + 1) * n2] = m
    return out


@functools.lru_cache(maxsize=None)
def packed_encode_operator_split(cfg: CodecConfig, chroma: bool = False):
    """Block-diagonal bf16 split parts (three (128,128)) + (1,128) f32 bias.

    128 // n2 whole blocks ride per 128-wide row. Every encode contracts
    over this SAME padded K=128 axis: the f32 accumulation trees of a
    K=n2 dot and a K=128 dot are not guaranteed to round identically at
    exact ties (observed: one +-1 pixel at N=4), so one formula keeps
    containers identical across the code paths and devices that share
    it. Whether a plain K=n2 contraction would still meet parity on the
    GPU is ROADMAP S5/D4.
    """
    parts = []
    for part in tables.fused_encode_operator_split(cfg, chroma=chroma)[:3]:
        parts.append(_block_diag(part, 128 // part.shape[0]))
    _, b = tables.fused_encode_operator(cfg, chroma=chroma)
    b2 = np.tile(np.asarray(b, np.float32), 128 // b.shape[0])[None, :]
    return parts[0], parts[1], parts[2], b2


@functools.lru_cache(maxsize=None)
def packed_decode_operator(cfg: CodecConfig, chroma: bool = False):
    """Block-diagonal (128, 128) fused decode matrix (+128 bias scalar)."""
    m, b = tables.fused_decode_operator(cfg, chroma=chroma)
    return _block_diag(np.asarray(m, np.float32), 128 // m.shape[0]), float(b)


@functools.lru_cache(maxsize=None)
def packed_ac_mask(n2: int) -> np.ndarray:
    """(1, 128) mask: 0 at each block's DC column, 1 elsewhere."""
    mask = np.ones((1, 128), np.float32)
    mask[0, ::n2] = 0.0
    return mask


def expand_block_scale(s: jax.Array, n2: int) -> jax.Array:
    """(rows, bpr) per-block scalar -> (rows, 128), each block's scalar
    repeated over its n2 columns (broadcast + where chain)."""
    rows, bpr = s.shape
    sub = jax.lax.broadcasted_iota(jnp.int32, (rows, 128), 1) // n2
    out = jnp.broadcast_to(s[:, 0:1], (rows, 128))
    for j in range(1, bpr):
        out = jnp.where(sub == j, s[:, j : j + 1], out)
    return out


def pack_rows(x: jax.Array) -> tuple[jax.Array, int]:
    """(B, n2) -> ((ceil(B/bpr), 128) packed rows, original B)."""
    B, n2 = x.shape
    bpr = 128 // n2
    rows = -(-B // bpr)
    pad = rows * bpr - B
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
    return x.reshape(rows, 128), B


def _pad_scale(s: jax.Array, rows: int, bpr: int) -> jax.Array:
    pad = rows * bpr - s.shape[0]
    if pad:
        s = jnp.pad(s, (0, pad), constant_values=1.0)
    return s.reshape(rows, bpr)


def split_operand_matmul(x, m0, m1, m2, b) -> jax.Array:
    """The canonical split-operand encode matmul: f32 accumulation of three
    default-precision bf16 passes (see tables.fused_encode_operator_split).

    ``x`` must hold integer pixel values in [0, 255] (exact in bf16). The
    left-associated sum order is load-bearing: every encode path (single
    device, sharded, rate-control probes) uses THIS function's formula so
    their rounded coefficients are bit-identical.
    """
    xb = x.astype(jnp.bfloat16)
    y = jnp.dot(xb, jnp.asarray(m0), preferred_element_type=jnp.float32)
    y = y + jnp.dot(xb, jnp.asarray(m1), preferred_element_type=jnp.float32)
    y = y + jnp.dot(xb, jnp.asarray(m2), preferred_element_type=jnp.float32)
    return y + jnp.asarray(b)


def encode_blocks(
    pixels_flat: jax.Array,
    cfg: CodecConfig,
    block_variance: jax.Array | None = None,
    chroma: bool = False,
    adaptive_scale: jax.Array | None = None,
) -> jax.Array:
    """Raw pixel blocks -> quantized zigzag coefficients, one fused matmul.

    Args:
      pixels_flat: (B, N^2) row-major-flattened blocks, u8 or float (raw
        pixel values, NOT level-shifted; the shift is folded into the bias).
      cfg: codec config (quality, adaptive, ...).
      block_variance: (B,) per-block pixel variance, required when
        cfg.adaptive. Computed on the *level-shifted* block, matching
        test_entropy.c:315 which passes the shifted block to
        calculate_block_variance.
      chroma: use the chrominance quant table (color extension).

    Returns:
      (B, N^2) int32 quantized coefficients in zigzag order.

    Fuses dct.c:115 + dct.c:52-74 + entropy.c:158-181 + quantization.c:113-131
    into ``round((x @ M + b) * s)`` where ``s`` is the per-block adaptive
    reciprocal scale (1 everywhere when not adaptive; never applied to DC,
    quantization.c:198-199).

    The matmul is the split-operand form (tables.fused_encode_operator_split):
    pixels are exact in bf16, the operator rides as three bf16 terms — half
    the passes of an f32 HIGHEST product at the same oracle-parity
    accuracy. For n2 in PACKED_N2 the computation runs in the packed-row
    block-diagonal form (see packed_encode_operator_split).
    """
    r = None
    if cfg.adaptive:
        if adaptive_scale is not None:
            s = adaptive_scale.astype(jnp.float32)  # (B,) wire-exact scale
        elif block_variance is not None:
            from dct_tpu.ops.quant import adaptive_quant_scale

            s = adaptive_quant_scale(block_variance).astype(jnp.float32)
        else:
            raise ValueError("adaptive quantization requires block_variance")
        # quantize divides by (q * s) for AC -> multiply the q-normalized
        # coefficient by 1/s (quantization.c:190, :124). Applied as ONE
        # multiply + select (never an add/mul chain a compiler could fuse
        # into an FMA) so every backend rounds identically — containers
        # must not depend on the device that encoded them.
        r = 1.0 / s
    n2 = cfg.n2
    if n2 in PACKED_N2:
        bpr = 128 // n2
        x2, B = pack_rows(pixels_flat)
        y = split_operand_matmul(
            x2, *packed_encode_operator_split(cfg, chroma=chroma)
        )
        if r is not None:
            r2 = expand_block_scale(_pad_scale(r, y.shape[0], bpr), n2)
            y = jnp.where(jnp.asarray(packed_ac_mask(n2)) != 0, y * r2, y)
        y = y.reshape(y.shape[0] * bpr, n2)[:B]
    elif n2 == 256:
        # 16x16: explicit K=128 halves fix the contraction association (a
        # K=256 dot's f32 accumulation tree is not guaranteed to round the
        # same way on every backend)
        m0, m1, m2, b = tables.fused_encode_operator_split(
            cfg, chroma=chroma
        )
        xb = pixels_flat.astype(jnp.bfloat16)
        xlo, xhi = xb[:, :128], xb[:, 128:]
        y = None
        for part in (m0, m1, m2):
            pj = jnp.asarray(part)
            t = jnp.dot(
                xlo, pj[:128, :], preferred_element_type=jnp.float32
            ) + jnp.dot(xhi, pj[128:, :], preferred_element_type=jnp.float32)
            y = t if y is None else y + t
        y = y + jnp.asarray(b)
        if r is not None:
            ac = jnp.asarray(tables.adaptive_scale_mask(cfg))  # 0 at DC
            y = jnp.where(ac[None, :] != 0, y * r[:, None], y)
    else:
        y = split_operand_matmul(
            pixels_flat,
            *tables.fused_encode_operator_split(cfg, chroma=chroma),
        )
        if r is not None:
            ac = jnp.asarray(tables.adaptive_scale_mask(cfg))  # 0 at DC
            y = jnp.where(ac[None, :] != 0, y * r[:, None], y)
    return round_half_away(y).astype(jnp.int32)


def decode_blocks(
    zz_coeffs: jax.Array,
    cfg: CodecConfig,
    block_variance: jax.Array | None = None,
    chroma: bool = False,
    adaptive_scale: jax.Array | None = None,
) -> jax.Array:
    """Quantized zigzag coefficients -> reconstructed u8 pixel blocks.

    Mirror of encode_blocks: fuses quantization.c:133-151 (dequant; or its
    bug-B1 variant under cfg.compat_b1) + entropy.c:183-210 (inverse zigzag)
    + dct.c:80-105 (IDCT) + the +128/clamp epilogue into
    ``clip(round(z * s @ M + 128), 0, 255)``.

    Returns (B, N^2) uint8 flattened pixel blocks.

    For n2 in PACKED_N2 the dequant+IDCT runs in the packed-row
    block-diagonal form, mirroring encode_blocks.
    """
    s = None
    if cfg.adaptive:
        if adaptive_scale is not None:
            s = adaptive_scale.astype(jnp.float32)
        elif block_variance is not None:
            from dct_tpu.ops.quant import adaptive_quant_scale

            s = adaptive_quant_scale(block_variance).astype(jnp.float32)
        else:
            raise ValueError("adaptive dequantization requires block_variance")
        # Correct adaptive dequant multiplies AC by (q * s); M already carries
        # q, so apply the extra s on AC inputs (quantization.c:193 double-
        # inverts to the same result — SURVEY.md B1 analysis). One multiply +
        # select, for the same cross-compiler bit-identity as encode_blocks.
    n2 = cfg.n2
    if n2 in PACKED_N2:
        bpr = 128 // n2
        m2, b = packed_decode_operator(cfg, chroma=chroma)
        z, B = pack_rows(zz_coeffs.astype(jnp.float32))
        if s is not None:
            s2 = expand_block_scale(_pad_scale(s, z.shape[0], bpr), n2)
            z = jnp.where(jnp.asarray(packed_ac_mask(n2)) != 0, z * s2, z)
        y = jnp.dot(z, jnp.asarray(m2), precision=_PREC) + b
        rec = jnp.clip(round_half_away(y), 0.0, 255.0).astype(jnp.uint8)
        return rec.reshape(z.shape[0] * bpr, n2)[:B]
    m, b = tables.fused_decode_operator(cfg, chroma=chroma)
    z = zz_coeffs.astype(m.dtype)
    if s is not None:
        ac = jnp.asarray(tables.adaptive_scale_mask(cfg))
        z = jnp.where(ac[None, :] != 0, z * s[:, None], z)
    y = jnp.dot(z, jnp.asarray(m), precision=_PREC) + b  # b carries the +128
    rec = jnp.clip(round_half_away(y), 0.0, 255.0).astype(jnp.uint8)
    return rec.reshape(z.shape[0], cfg.n2)


def dequantized_coeffs(
    zz_coeffs: jax.Array, cfg: CodecConfig, block_variance: jax.Array | None = None
) -> jax.Array:
    """Dequantize zigzag coefficients back to float DCT-coefficient blocks
    (B, N, N) in natural order — the reference's ``dequantize`` output
    (quantization.c:133-151), exposed for layer-level tests."""
    q = np.asarray(tables.quant_matrix(cfg.block_size, cfg.quality)).ravel()
    qz = q[tables.zigzag_permutation(cfg.block_size)]
    dq = (1.0 / qz) if cfg.compat_b1 else qz
    dq = jnp.asarray(dq, dtype=jnp.dtype(cfg.dtype))
    z = zz_coeffs.astype(dq.dtype)
    if cfg.adaptive:
        from dct_tpu.ops.quant import adaptive_quant_scale

        s = adaptive_quant_scale(block_variance).astype(dq.dtype)
        ac = jnp.asarray(tables.adaptive_scale_mask(cfg))
        z = z * (1.0 + ac[None, :] * (s[:, None] - 1.0))
    y = z * dq[None, :]
    inv = tables.inverse_zigzag_permutation(cfg.block_size)
    b = y[:, jnp.asarray(inv)]
    return b.reshape(-1, cfg.block_size, cfg.block_size)
