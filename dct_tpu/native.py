"""Bindings to the native C++ bitstream codec (native/bitpack.cpp ->
build/libdctbits.so).

The hot decode loop (canonical-Huffman symbol decode + coefficient
placement) is inherently serial per stripe; stripes are independent, so the
native decoder runs them via a simple pthread pool. The Python fallback in
ops/bitstream.py is the behavioral reference; tests assert byte-for-byte
agreement.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
from typing import Optional

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parent.parent
_LIB_PATH = _REPO / "build" / "libdctbits.so"

_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_MODE_IDS = {"category": 0, "direct": 1, "none": 2}

# Must equal bitpack.cpp's dctbits_abi_version(). v2: unpack_stripes
# writes int16 coefficients (v1 wrote int32 — calling a v1 library
# through the v2 signature would overflow the half-size output buffer).
_ABI_VERSION = 2


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", str(_REPO / "native"), str(_LIB_PATH)],
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
    # always run make: it is a no-op when fresh and rebuilds a stale .so
    # (e.g. one predating a newly added entry point)
    if not _build() and not _LIB_PATH.exists():
        _build_failed = True
        return None
    try:
        lib = _bind(ctypes.CDLL(str(_LIB_PATH)))
    except (OSError, AttributeError):
        # unloadable, or a stale prebuilt .so missing a newer entry point
        # that make could not rebuild: fall back to the Python paths
        _build_failed = True
        return None
    _lib = lib
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    # ABI handshake BEFORE binding any signature: a stale .so that make
    # failed to rebuild must fall back to the Python paths, not be called
    # through mismatched argtypes. AttributeError (symbol absent = v1)
    # propagates to _load's except; a version mismatch raises OSError.
    lib.dctbits_abi_version.restype = ctypes.c_int
    ver = lib.dctbits_abi_version()
    if ver != _ABI_VERSION:
        raise OSError(
            f"libdctbits ABI {ver} != expected {_ABI_VERSION} (stale build)"
        )
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.dctbits_unpack_stripes.argtypes = [
        u8p,              # concatenated stripe bytes
        ctypes.POINTER(ctypes.c_uint64),  # per-stripe byte offsets (n+1)
        ctypes.c_int,     # n_stripes
        ctypes.c_int,     # blocks per stripe
        ctypes.c_int,     # n2
        ctypes.c_int,     # mode id
        u8p,              # table lengths
        ctypes.c_int,     # table size
        u8p,              # run-table lengths (coded_runs; unused if size 0)
        ctypes.c_int,     # run-table size (0 = fixed 8-bit run field)
        ctypes.c_int,     # vmin
        i16p,             # out (n_stripes * bps * n2; wire values are i16)
        ctypes.c_int,     # n_threads
    ]
    lib.dctbits_unpack_stripes.restype = ctypes.c_int
    lib.dctbits_verify_stripes.argtypes = [
        u8p,              # concatenated stripe bytes
        ctypes.POINTER(ctypes.c_uint64),  # per-stripe byte offsets (n+1)
        ctypes.c_int,     # n_stripes
        ctypes.c_int,     # blocks per stripe
        ctypes.c_int,     # n2
        ctypes.c_int,     # mode id
        u8p,              # table lengths
        ctypes.c_int,     # table size
        u8p,              # run-table lengths
        ctypes.c_int,     # run-table size
        ctypes.c_int,     # vmin
        u32p,             # expected bits per stripe
        i32p,             # status out (0 ok / 2 bad symbol / 3 overrun /
                          # 4 bit-count mismatch)
        ctypes.c_int,     # n_threads
    ]
    lib.dctbits_verify_stripes.restype = ctypes.c_int
    lib.dctbits_pack_block_symbols.argtypes = [
        i32p, i32p, ctypes.c_int,  # values, runs, count
        ctypes.c_int,              # mode id
        u8p, u32p, ctypes.c_int,   # table lengths, codes, size
        ctypes.c_int,              # vmin
        u8p, ctypes.c_uint64,      # out buffer, capacity bytes
        ctypes.c_int,              # n2 (fixed run-field width derives from it)
    ]
    lib.dctbits_pack_block_symbols.restype = ctypes.c_int64
    return lib


def available() -> bool:
    return _load() is not None


def _marshal_stripes(stripes: list[bytes], table, run_table):
    """Shared ctypes marshalling for the stripe-array entry points."""
    n_stripes = len(stripes)
    blob = b"".join(stripes)
    offsets = np.zeros(n_stripes + 1, np.uint64)
    np.cumsum([len(s) for s in stripes], out=offsets[1:])
    buf = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
    buf = np.ascontiguousarray(buf)
    if table is not None:
        lengths = np.ascontiguousarray(table.lengths, np.uint8)
    else:
        lengths = np.zeros(1, np.uint8)
    if run_table is not None:
        run_lengths = np.ascontiguousarray(run_table.lengths, np.uint8)
        run_size = len(run_lengths)
    else:
        run_lengths = np.zeros(1, np.uint8)
        run_size = 0
    return n_stripes, buf, offsets, lengths, run_lengths, run_size


def unpack_stripes(
    stripes: list[bytes],
    blocks_per_stripe: int,
    n2: int,
    mode: str,
    table,
    vmin: int,
    run_table=None,
    n_threads: int | None = None,
) -> np.ndarray:
    """Decode stripe substreams -> (n_stripes * bps, n2) int16 zigzag.

    int16 because the wire values are 16-bit two's complement — half the
    store traffic here and half the coefficient-upload bytes on the
    unindexed decode_to_device path. The
    buffer starts uninitialized; the C decoder zeroes each block in its
    own loop (a separate full-array fill cost ~15% of the entropy path).

    n_threads defaults to the host's core count (stripes are the parallel
    axis)."""
    import os

    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib = _load()
    n_stripes, buf, offsets, lengths, run_lengths, run_size = (
        _marshal_stripes(stripes, table, run_table)
    )
    out = np.empty((n_stripes * blocks_per_stripe, n2), np.int16)
    rc = lib.dctbits_unpack_stripes(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_stripes,
        blocks_per_stripe,
        n2,
        _MODE_IDS[mode],
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(lengths),
        run_lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        run_size,
        vmin,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        n_threads,
    )
    if rc != 0:
        raise ValueError(f"native stripe decode failed with code {rc}")
    return out


def verify_stripes(
    stripes: list[bytes],
    blocks_per_stripe: int,
    n2: int,
    mode: str,
    table,
    vmin: int,
    expected_bits: np.ndarray,
    run_table=None,
    n_threads: int | None = None,
) -> np.ndarray:
    """Integrity-scan stripe substreams -> (n_stripes,) int32 status.

    0 = ok; 2 = invalid symbol; 3 = overrun; 4 = decode consumed a bit
    count different from the container's record. Same contract as the
    Python scan in models/recovery.py, on the C++ LUT decoder's thread
    pool."""
    import os

    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib = _load()
    n_stripes, buf, offsets, lengths, run_lengths, run_size = (
        _marshal_stripes(stripes, table, run_table)
    )
    exp = np.ascontiguousarray(expected_bits, np.uint32)
    status = np.zeros(n_stripes, np.int32)
    lib.dctbits_verify_stripes(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_stripes,
        blocks_per_stripe,
        n2,
        _MODE_IDS[mode],
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(lengths),
        run_lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        run_size,
        vmin,
        exp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    return status
