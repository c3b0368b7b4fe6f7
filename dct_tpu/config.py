"""Codec configuration.

The C reference threads its configuration through context constructors as three
positional knobs: ``block_size`` (reference ``dct.c:7``, ``quantization.c:19``),
``quality`` clamped to [1, 100] (``quantization.c:26-31``), ``adaptive`` 0/1
(``quantization.h:23``) and ``use_huffman`` 0/1 (``entropy.c:128-130``).

Here the whole configuration is one frozen dataclass, hashable so it can be a
static argument to ``jax.jit``. All derived constant arrays (DCT basis, quant
tables, zigzag permutation, fused encode/decode matrices) are pure functions of
this config — see :mod:`dct_tpu.tables`.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

HuffmanMode = Literal["category", "direct", "none"]
ChromaMode = Literal["gray", "444", "420"]


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Full configuration of the codec pipeline.

    Attributes:
      block_size: transform block size N (the reference supports arbitrary N
        with a synthetic radial quant table for N != 8, ``quantization.c:81-95``).
      quality: JPEG-style quality in [1, 100]; values outside are clamped,
        matching ``quantization.c:26-31``.
      adaptive: per-block variance-adaptive quantization
        (``quantization.c:171-211``).
      use_huffman: Huffman-code the RLE values; if False, fixed 16+8-bit
        symbols (the reference's non-Huffman size accounting,
        ``entropy.c:395``).
      huffman_mode: how values are entropy-coded in the *real* bitstream (the
        reference never emits bits — SURVEY.md B2):
          * ``"category"`` — JPEG-style magnitude-category + extra bits.
            Bounded alphabet, per-image canonical table. Default.
          * ``"direct"`` — canonical Huffman over the observed value alphabet.
            Closest to the reference's per-value code table
            (``entropy.c:261-328``).
          * ``"none"`` — fixed-length 16-bit values.
        Run lengths are always fixed 8 bits (reference convention,
        ``entropy.c:390``).
      static_tables: use a fixed default category table instead of building
        a per-image table from the histogram. Single device dispatch (no
        histogram sync), fully jittable end-to-end; slightly worse
        compression. Only meaningful with huffman_mode="category".
      dc_prediction: delta-code each block's DC coefficient against the
        previous block within its stripe (stripe-local DPCM, like JPEG's
        DC prediction — the reference codes every DC raw). Lossless in the
        integer domain, preserves per-stripe independence (recovery,
        sharding), and combines with coded_runs for the smallest files.
      coded_runs: Huffman-code the run field with its own canonical table
        (per-image, or the measured default under static_tables) instead of
        the reference's flat 8 bits (``entropy.c:390``). ~83% of runs are
        <= 3 on photographic content, so this cuts bitstreams by roughly a
        third at q50 while every worst-case shape stays identical (run
        codes are capped at 8 bits). Off by default = wire-compatible with
        the reference-convention layout.
      compat_b1: reproduce reference bug B1 — the non-adaptive dequantize
        multiplies by ``1/q`` instead of ``q`` (``quantization.c:144`` with the
        reciprocal table from ``quantization.c:106``). Off by default; the
        default path uses the mathematically correct dequantization.
      chroma: color handling — ``"gray"`` single plane, ``"444"`` YCbCr
        full-resolution chroma, ``"420"`` 2x2-subsampled chroma.
      stripe_rows: number of *block rows* per bitstream stripe. Stripes are
        the unit of parallel/sharded entropy coding and of decode
        parallelism; the serialized container stores one byte-aligned
        substream per stripe, so output bits are identical for any device
        mesh (SURVEY.md section 5.8).
      decode_index: store per-BLOCK bit lengths in the container
        (container v2) — the restart-marker analog that makes every block
        an independently addressable substream, so the device entropy
        decoder (ops/entropy_decode.py, plain lax) decodes every block of
        a plane at once instead of the host's serial per-symbol loop, and
        decode_to_device never sends coefficients over the host link.
        The index is bit-packed at the per-plane width the data needs
        (container.py flags2 bit1). Values: True (always index), False
        (never, v1 wire format), "auto" (the default: index the container
        only when the packed index is <= container.AUTO_INDEX_BOUND of
        the payload; its size on the real-image set is measured by
        benchmarks/index_cost.py). Computing the per-block lengths is a
        reduction the staged encode does anyway.
      dtype: compute dtype for the transform matmuls. float32 keeps the
        quantized integer outputs exact w.r.t. the float64 C oracle for all
        8-bit inputs (verified by tests/test_parity.py).
    """

    block_size: int = 8
    quality: int = 50
    adaptive: bool = False
    use_huffman: bool = True
    huffman_mode: HuffmanMode = "category"
    static_tables: bool = False
    coded_runs: bool = False
    dc_prediction: bool = False
    compat_b1: bool = False
    chroma: ChromaMode = "gray"
    stripe_rows: int = 1
    decode_index: bool | str = "auto"
    dtype: str = "float32"

    def __post_init__(self):
        if self.block_size < 2:
            raise ValueError(f"block_size must be >= 2, got {self.block_size}")
        if self.decode_index not in (True, False, "auto"):
            raise ValueError(
                f"decode_index must be True, False or 'auto', got "
                f"{self.decode_index!r}"
            )
        if self.coded_runs and self.block_size > 8:
            # The run-code alphabet (and the TPDC wire format's 65-entry
            # run table) covers runs 0..64; N > 8 blocks produce runs up
            # to N^2, which would silently index past the table and emit
            # an undecodable stream. The fixed 8-bit run field handles any
            # N <= 16.
            raise ValueError(
                "coded_runs requires block_size <= 8 (run alphabet is 0..64)"
            )
        # Reference clamps rather than rejects (quantization.c:26-31).
        q = min(100, max(1, int(self.quality)))
        object.__setattr__(self, "quality", q)

    @property
    def n(self) -> int:
        return self.block_size

    @property
    def n2(self) -> int:
        return self.block_size * self.block_size

    def replace(self, **kw) -> "CodecConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = CodecConfig()
