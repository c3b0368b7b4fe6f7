"""ctypes bindings to the golden-parity oracle (the unmodified C reference
linked behind a flat-array ABI — see native/oracle_driver.c).

The oracle is a *test dependency only*: it defines what "reference behavior"
means (including bug B1) so the JAX pipeline can be checked for bit-exact
integer-domain parity. Production code never imports this module.

Builds lazily via ``make -C native`` on first use; callers should treat
:func:`available` returning False (no compiler / no reference mount) as a
skip condition.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
from typing import Optional

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parent.parent
_LIB_PATH = _REPO / "build" / "liboracle.so"
_REF_PATH = pathlib.Path(os.environ.get("DCT_REFERENCE_PATH", "/root/reference"))

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    if not (_REF_PATH / "src" / "dct.c").exists():
        return False
    try:
        subprocess.run(
            ["make", "-C", str(_REPO / "native"), f"REF={_REF_PATH}",
             str(_LIB_PATH)],
            check=True, capture_output=True, text=True, timeout=120,
        )
        return _LIB_PATH.exists()
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not _LIB_PATH.exists() and not _build():
        _build_failed = True
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int)
    c_up = ctypes.POINTER(ctypes.c_ubyte)
    lib.oracle_dct_matrix.argtypes = [ctypes.c_int, c_dp]
    lib.oracle_dct_forward.argtypes = [ctypes.c_int, c_dp, c_dp]
    lib.oracle_dct_inverse.argtypes = [ctypes.c_int, c_dp, c_dp]
    lib.oracle_quant_matrix.argtypes = [ctypes.c_int, ctypes.c_int, c_dp]
    lib.oracle_block_variance.argtypes = [ctypes.c_int, c_dp]
    lib.oracle_block_variance.restype = ctypes.c_double
    lib.oracle_quantize.argtypes = [ctypes.c_int] * 3 + [c_dp, ctypes.c_double, c_ip]
    lib.oracle_dequantize.argtypes = [ctypes.c_int] * 3 + [c_ip, ctypes.c_double, c_dp]
    lib.oracle_zigzag.argtypes = [ctypes.c_int, c_ip, c_ip]
    lib.oracle_inv_zigzag.argtypes = [ctypes.c_int, c_ip, c_ip]
    lib.oracle_rle_encode.argtypes = [ctypes.c_int, c_ip, c_ip, c_ip]
    lib.oracle_rle_encode.restype = ctypes.c_int
    lib.oracle_rle_decode.argtypes = [ctypes.c_int, c_ip, c_ip, ctypes.c_int, c_ip]
    lib.oracle_encoded_size.argtypes = [c_ip, c_ip, ctypes.c_int, ctypes.c_int]
    lib.oracle_encoded_size.restype = ctypes.c_int
    lib.oracle_encode_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_up, ctypes.c_int,
    ]
    lib.oracle_encode_batch.restype = ctypes.c_longlong
    lib.oracle_block_pipeline.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_up, c_ip, c_up, c_ip,
    ]
    lib.oracle_block_pipeline.restype = ctypes.c_int
    lib.oracle_decode_batch_seconds.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, c_up, ctypes.c_int,
    ]
    lib.oracle_decode_batch_seconds.restype = ctypes.c_double
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _up(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def dct_matrix(n: int) -> np.ndarray:
    lib = _load()
    out = np.zeros((n, n), np.float64)
    lib.oracle_dct_matrix(n, _dp(out))
    return out


def dct_forward(block: np.ndarray) -> np.ndarray:
    lib = _load()
    n = block.shape[0]
    a = np.ascontiguousarray(block, np.float64)
    out = np.zeros((n, n), np.float64)
    lib.oracle_dct_forward(n, _dp(a), _dp(out))
    return out


def dct_inverse(block: np.ndarray) -> np.ndarray:
    lib = _load()
    n = block.shape[0]
    a = np.ascontiguousarray(block, np.float64)
    out = np.zeros((n, n), np.float64)
    lib.oracle_dct_inverse(n, _dp(a), _dp(out))
    return out


def quant_matrix(n: int, quality: int) -> np.ndarray:
    lib = _load()
    out = np.zeros((n, n), np.float64)
    lib.oracle_quant_matrix(n, quality, _dp(out))
    return out


def block_variance(block: np.ndarray) -> float:
    lib = _load()
    a = np.ascontiguousarray(block, np.float64)
    return float(lib.oracle_block_variance(block.shape[0], _dp(a)))


def quantize(coeffs: np.ndarray, quality: int, adaptive: bool = False,
             variance: float = 0.0) -> np.ndarray:
    lib = _load()
    n = coeffs.shape[0]
    a = np.ascontiguousarray(coeffs, np.float64)
    out = np.zeros((n, n), np.int32)
    lib.oracle_quantize(n, quality, int(adaptive), _dp(a), variance, _ip(out))
    return out


def dequantize(qcoeffs: np.ndarray, quality: int, adaptive: bool = False,
               variance: float = 0.0) -> np.ndarray:
    lib = _load()
    n = qcoeffs.shape[0]
    a = np.ascontiguousarray(qcoeffs, np.int32)
    out = np.zeros((n, n), np.float64)
    lib.oracle_dequantize(n, quality, int(adaptive), _ip(a), variance, _dp(out))
    return out


def zigzag(block: np.ndarray) -> np.ndarray:
    lib = _load()
    n = block.shape[0]
    a = np.ascontiguousarray(block, np.int32)
    out = np.zeros(n * n, np.int32)
    lib.oracle_zigzag(n, _ip(a), _ip(out))
    return out


def inv_zigzag(zz: np.ndarray, n: int) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(zz, np.int32)
    out = np.zeros((n, n), np.int32)
    lib.oracle_inv_zigzag(n, _ip(a), _ip(out))
    return out


def rle_encode(qcoeffs: np.ndarray):
    """Returns (values, runs) as int32 arrays of length = symbol count."""
    lib = _load()
    n = qcoeffs.shape[0]
    a = np.ascontiguousarray(qcoeffs, np.int32)
    values = np.zeros(n * n, np.int32)
    runs = np.zeros(n * n, np.int32)
    count = lib.oracle_rle_encode(n, _ip(a), _ip(values), _ip(runs))
    return values[:count].copy(), runs[:count].copy()


def rle_decode(values: np.ndarray, runs: np.ndarray, n: int) -> np.ndarray:
    lib = _load()
    v = np.ascontiguousarray(values, np.int32)
    r = np.ascontiguousarray(runs, np.int32)
    out = np.zeros((n, n), np.int32)
    lib.oracle_rle_decode(n, _ip(v), _ip(r), len(v), _ip(out))
    return out


def encoded_size(values: np.ndarray, runs: np.ndarray,
                 use_huffman: bool = True) -> int:
    lib = _load()
    v = np.ascontiguousarray(values, np.int32)
    r = np.ascontiguousarray(runs, np.int32)
    return int(lib.oracle_encoded_size(_ip(v), _ip(r), len(v), int(use_huffman)))


def decode_batch_seconds(pixels: np.ndarray, quality: int = 50,
                         adaptive: bool = False) -> float:
    """Time the reference's decode half (run_length_decode -> dequantize ->
    dct_inverse -> +128/clamp) over (B, n, n) u8 blocks; encode happens
    untimed inside the C call. Returns decode wall seconds."""
    lib = _load()
    b, n = pixels.shape[0], pixels.shape[1]
    p = np.ascontiguousarray(pixels, np.uint8)
    return float(
        lib.oracle_decode_batch_seconds(n, quality, int(adaptive), _up(p), b)
    )


def encode_batch(pixels: np.ndarray, quality: int = 50, adaptive: bool = False,
                 use_huffman: bool = True) -> int:
    """Run the full reference encode over (B, n, n) u8 blocks in one C call;
    returns total estimated bits. Used for throughput baselining."""
    lib = _load()
    b, n = pixels.shape[0], pixels.shape[1]
    p = np.ascontiguousarray(pixels, np.uint8)
    return int(
        lib.oracle_encode_batch(n, quality, int(adaptive), int(use_huffman),
                                _up(p), b)
    )


def block_pipeline(pixels: np.ndarray, quality: int = 50, adaptive: bool = False,
                   use_huffman: bool = True):
    """Full reference encode+decode of one u8 block.

    Returns (zz_coeffs int32 (n^2,), recon u8 (n, n), bits int, count int) —
    mirrors test_with_dct_coefficients (test_entropy.c:278-405).
    """
    lib = _load()
    n = pixels.shape[0]
    p = np.ascontiguousarray(pixels, np.uint8)
    zz = np.zeros(n * n, np.int32)
    recon = np.zeros((n, n), np.uint8)
    bits = np.zeros(1, np.int32)
    count = lib.oracle_block_pipeline(
        n, quality, int(adaptive), int(use_huffman), _up(p), _ip(zz), _up(recon), _ip(bits)
    )
    return zz, recon, int(bits[0]), int(count)
