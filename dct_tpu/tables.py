"""Constant tables: DCT basis, quantization matrices, zigzag permutation, and
the fused encode/decode operators.

The C reference holds these in heap-allocated context structs
(``DCTContext`` at dct.h:21-25, ``QuantContext`` at quantization.h:18-24).
Here they are pure functions of :class:`~dct_tpu.config.CodecConfig`, built
once in float64 NumPy on the host, cached, and closed over by jitted
functions as constants.

The fused Kronecker operator
----------------------------
For a block ``X`` (N x N), the 2D DCT is ``Y = D @ X @ D.T`` (two matmuls in
the reference, dct.c:52-74). Flattening blocks row-major to length-N^2
vectors, this is a single linear map::

    vec(D X D^T) = (D (x) D) vec(X)        ((x) = Kronecker product)

so a *batch* of B blocks becomes ONE ``(B, N^2) @ (N^2, N^2)`` matmul — the
shape matrix units want. On top of that single matrix we fold, column by column:

  * the zigzag permutation (entropy.c:158-181) — permute columns, so the
    matmul emits coefficients already in zigzag order;
  * the quantization divide (quantization.c:124) — scale column k by
    ``1/q_zigzag[k]``;
  * the -128 level shift (dct.c:115) — DCT is linear, so the shift becomes a
    constant bias vector ``-128 * row_sums`` folded per output coefficient.

The entire reference encode front-end (level shift -> 2D DCT -> zigzag ->
quant divide) is then ``round(x @ M_enc + b_enc)``: one matmul, one bias add,
one round. The decode mirror folds dequantization and inverse zigzag into a
second matrix with a ``+128`` bias.

Precision note: the fused matrix is constructed in float64 and cast to
float32. The DC row of ``D (x) D`` is exactly ``1/N^2`` (a power of two for
N = 8), so DC coefficients are *exact* in float32 for 8-bit inputs; AC
rounding parity vs the float64 oracle is verified exhaustively in tests.
"""

from __future__ import annotations

import functools

import numpy as np

from dct_tpu.config import CodecConfig

# Standard JPEG luminance quantization table (ITU-T T.81 Annex K.1), the same
# table hardcoded by the reference at quantization.c:8-17.
JPEG_LUMA_QUANT = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float64,
)

# Standard JPEG chrominance quantization table (ITU-T T.81 Annex K.2). The
# reference is grayscale-only; the color path (models/color.py) uses this for
# Cb/Cr planes.
JPEG_CHROMA_QUANT = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float64,
)


@functools.lru_cache(maxsize=None)
def dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis matrix D (n x n), float64.

    D[i, j] = alpha(i) * cos(pi * (2j + 1) * i / (2n)) with
    alpha(0) = 1/sqrt(n), alpha(i>0) = sqrt(2/n) — the same basis the
    reference precomputes at dct.c:19-30.
    """
    i = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    alpha = np.where(i == 0, 1.0 / np.sqrt(n), np.sqrt(2.0 / n))
    return alpha * np.cos(np.pi * (2.0 * j + 1.0) * i / (2.0 * n))


def quality_scale_factor(quality: int) -> float:
    """JPEG quality -> quant-table scale (quantization.c:55-60).

    quality < 50: 5000/quality / 100;  quality >= 50: (200 - 2*quality) / 100.
    At quality 100 the factor is 0, so every entry clamps to 1.0 — the
    integer-lossless regime (SURVEY.md B8).
    """
    q = min(100, max(1, int(quality)))
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    return scale / 100.0


@functools.lru_cache(maxsize=None)
def quant_matrix(block_size: int, quality: int, chroma: bool = False) -> np.ndarray:
    """Quality-scaled quantization matrix, float64, entries clamped to [1, 255].

    block_size == 8 uses the JPEG table scaled per quality
    (quantization.c:62-77); other sizes use the reference's synthetic radial
    table ``(1 + sqrt(i^2 + j^2)) * scale * 8`` (quantization.c:81-95).
    ``chroma=True`` (an extension; the reference is luma-only) swaps in the
    standard JPEG chrominance table for block_size 8.
    """
    scale = quality_scale_factor(quality)
    if block_size == 8:
        base = JPEG_CHROMA_QUANT if chroma else JPEG_LUMA_QUANT
        m = base * scale
    else:
        i = np.arange(block_size)[:, None].astype(np.float64)
        j = np.arange(block_size)[None, :].astype(np.float64)
        dist = np.sqrt(i * i + j * j)
        m = (1.0 + dist) * scale * 8.0
    return np.clip(m, 1.0, 255.0)


@functools.lru_cache(maxsize=None)
def zigzag_permutation(n: int) -> np.ndarray:
    """Flat (row-major) indices in zigzag visit order, int32, shape (n*n,).

    ``zigzag[k] = block.ravel()[perm[k]]`` reproduces the reference's
    anti-diagonal traversal (entropy.c:158-181): even-sum diagonals walk
    up-right (row index decreasing), odd-sum diagonals walk down-left.
    """
    order = []
    for s in range(2 * (n - 1) + 1):
        if s % 2 == 0:
            i = min(s, n - 1)
            while i >= 0 and (s - i) < n:
                order.append(i * n + (s - i))
                i -= 1
        else:
            i = max(0, s - n + 1)
            while i < n and (s - i) >= 0:
                order.append(i * n + (s - i))
                i += 1
    return np.asarray(order, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def inverse_zigzag_permutation(n: int) -> np.ndarray:
    """Inverse permutation: ``block.ravel()[i] = zigzag[inv_perm[i]]``."""
    perm = zigzag_permutation(n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return inv


# ---------------------------------------------------------------------------
# Fused operators
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kron_dct(n: int) -> np.ndarray:
    """(D (x) D), float64, shape (n^2, n^2): row-major-flattened 2D DCT.

    With row-major flatten r(X): r(D X D^T) = (D (x) D) r(X).
    """
    d = dct_basis(n)
    return np.kron(d, d)


def _zigzag_quant(cfg: CodecConfig, chroma: bool = False) -> np.ndarray:
    """Quant table in zigzag order, float64, shape (n^2,)."""
    q = quant_matrix(cfg.block_size, cfg.quality, chroma=chroma).ravel()
    return q[zigzag_permutation(cfg.block_size)]


@functools.lru_cache(maxsize=None)
def fused_encode_operator(cfg: CodecConfig, chroma: bool = False):
    """(M_enc, b_enc) such that quantized zigzag coeffs = round(x @ M_enc + b_enc).

    ``x`` is a (B, n^2) batch of row-major-flattened pixel blocks (raw u8
    values as floats, NO level shift — the shift is folded into b_enc).

      M_enc[:, k] = (D (x) D)[perm[k], :] / q_zz[k]
      b_enc[k]    = -128 * sum_j (D (x) D)[perm[k], j] / q_zz[k]

    Fuses: level shift (dct.c:115) + forward DCT (dct.c:52-74) + zigzag
    (entropy.c:158-181) + quant divide (quantization.c:124). Built in float64,
    returned as cfg.dtype (float32 by default).
    """
    n = cfg.block_size
    K = _kron_dct(n)  # (n2, n2): out_flat = K @ x_flat
    perm = zigzag_permutation(n)
    qz = _zigzag_quant(cfg, chroma=chroma)  # (n2,)
    Kp = K[perm, :] / qz[:, None]  # rows permuted + scaled
    bias = -128.0 * Kp.sum(axis=1)
    dtype = np.dtype(cfg.dtype)
    # x @ M_enc where M_enc = Kp.T  ==> out[k] = sum_j x[j] Kp[k, j]
    return Kp.T.astype(dtype), bias.astype(dtype)


@functools.lru_cache(maxsize=None)
def fused_encode_operator_split(cfg: CodecConfig, chroma: bool = False):
    """3-way bf16 split of the f32 encode operator: (m0, m1, m2, b_enc).

    m0 + m1 + m2 reconstructs ~24 mantissa bits of M_enc — the operator
    precision of an f32 product. Pixels are u8, and every integer <= 255
    is EXACT in bf16 (8 significant bits), so the input needs no split at
    all: THREE default-precision bf16 passes

        y = x_bf16 @ m0 + x_bf16 @ m1 + x_bf16 @ m2 + b    (f32 accum)

    match the float64 oracle except at exact .5 ties
    (tests/test_parity.py). Every encode path MUST use this exact sum
    order — byte-identical containers across paths depend on it.
    """
    import ml_dtypes  # numpy bf16 (ships with jax); keeps tables jax-free

    m, b = fused_encode_operator(cfg, chroma=chroma)
    rem = np.asarray(m, np.float32)
    parts = []
    for _ in range(3):
        p = rem.astype(ml_dtypes.bfloat16)
        parts.append(p)
        rem = rem - p.astype(np.float32)
    return parts[0], parts[1], parts[2], np.asarray(b, np.float32)


@functools.lru_cache(maxsize=None)
def fused_decode_operator(cfg: CodecConfig, chroma: bool = False):
    """(M_dec, b_dec) such that pixels = clip(round(z @ M_dec + b_dec), 0, 255).

    ``z`` is a (B, n^2) batch of quantized zigzag coefficients.

      M_dec[k, :] = dq[k] * (D (x) D)[perm[k], :]      (inverse = transpose:
                                                         D orthonormal)
      b_dec       = +128

    where ``dq`` is the dequantization step per zigzag coefficient:
    ``q_zz`` normally, or ``1/q_zz`` when cfg.compat_b1 reproduces reference
    bug B1 (quantization.c:144 multiplying by the reciprocal table from
    quantization.c:106).

    Fuses: dequant (quantization.c:133-151) + inverse zigzag
    (entropy.c:183-210) + inverse DCT (dct.c:80-105) + level unshift.
    """
    n = cfg.block_size
    K = _kron_dct(n)
    perm = zigzag_permutation(n)
    qz = _zigzag_quant(cfg, chroma=chroma)
    # B1 only afflicts the NON-adaptive reference path; the adaptive path
    # double-inverts back to the correct q*scale (quantization.c:144 with
    # the adjusted matrix from quantization.c:193).
    dq = (1.0 / qz) if (cfg.compat_b1 and not cfg.adaptive) else qz
    # x_flat = K^T @ y_flat (orthonormal); y_flat[perm[k]] = dq[k] * z[k]
    # => pixels_flat[j] = sum_k z[k] * dq[k] * K[perm[k], j]
    M = (dq[:, None] * K[perm, :]).astype(np.dtype(cfg.dtype))
    return M, np.asarray(128.0, dtype=np.dtype(cfg.dtype))


@functools.lru_cache(maxsize=None)
def adaptive_scale_mask(cfg: CodecConfig) -> np.ndarray:
    """Per-zigzag-coefficient mask for adaptive scaling: 0 for DC, 1 for AC.

    The reference never scales the (0,0) entry (quantization.c:198-199);
    zigzag position 0 is always DC.
    """
    m = np.ones(cfg.n2, dtype=np.dtype(cfg.dtype))
    m[0] = 0.0
    return m
