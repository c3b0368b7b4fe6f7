"""dct_tpu — a block-transform image codec framework in JAX.

A ground-up JAX/XLA re-design of the pipeline specified by the C
reference ``erkinov-wtf/dct`` (adaptive-DCT JPEG-style compressor):
level-shift -> 2D DCT-II -> (adaptive) quantization -> zigzag -> RLE ->
Huffman -> real serialized bitstream (which the reference lacks) -> decode
mirror. See SURVEY.md for the structural analysis and ARCHITECTURE.md for
how each reference component maps onto this package.
"""

from dct_tpu.config import CodecConfig, DEFAULT_CONFIG
from dct_tpu import tables

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "DEFAULT_CONFIG",
    "tables",
    "encode",
    "decode",
    "encode_to_size",
    "encode_to_psnr",
    "__version__",
]


def encode(image, config: CodecConfig | None = None) -> bytes:
    """Top-level convenience: u8 image array -> TPDC container bytes.

    Grayscale (H, W) or RGB (H, W, 3) by array rank; see
    dct_tpu.models.codec for the full API (codecs, recovery, video).
    """
    from dct_tpu.models import codec

    return codec.encode(image, config)


def decode(data: bytes):
    """TPDC container bytes -> reconstructed u8 image array."""
    from dct_tpu.models import codec

    return codec.decode(data)


def encode_to_size(image, max_bytes: int, config: CodecConfig | None = None):
    """Encode to a byte budget (exact size probes): (bytes, quality).
    Full API: dct_tpu.models.rate_control."""
    from dct_tpu.models import rate_control

    return rate_control.encode_to_size(image, max_bytes, config)


def encode_to_psnr(image, min_psnr: float, config: CodecConfig | None = None):
    """Encode to a distortion target (exact PSNR probes): (bytes, quality).
    Full API: dct_tpu.models.rate_control."""
    from dct_tpu.models import rate_control

    return rate_control.encode_to_psnr(image, min_psnr, config)
