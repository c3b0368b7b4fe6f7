"""TPDC container format — the serialized artifact.

The reference never defines one (Huffman codes are built but no bits are
ever written, SURVEY.md B2); per SURVEY.md section 5.4 the container doubles
as the checkpoint/resume unit: every stripe is an independent byte-aligned
substream with its own recorded bit length, so

  * multi-shard encodes concatenate deterministically (bit-identical output
    for any device mesh — the stripe boundaries are a property of the image,
    not of the mesh);
  * decode parallelizes across stripes;
  * a partially damaged or partially re-encoded file recovers per stripe.

Layout (little-endian):

  header (20 B; version 2 appends 1 B):
    0  magic   b"TPDC"
    4  version u8 (1, or 2 when extension flags are present)
    5  flags   u8: bit0 adaptive, bit1 use_huffman,
                   bits2-3 huffman_mode (0 category, 1 direct, 2 none),
                   bit4 compat_b1, bit5 static_tables, bit6 coded_runs,
                   bit7 dc_prediction
    6  block_size u8
    7  quality    u8
    8  width      u32
    12 height     u32
    16 n_planes   u8
    17 chroma     u8 (0 gray, 1 4:4:4, 2 4:2:0)
    18 stripe_rows u16
    [version >= 2] 20 flags2 u8: bit0 decode_index,
                   bit1 packed index (see decode_index below)

  per plane:
    plane_w u32, plane_h u32, n_stripes u32
    table section (mode-dependent):
      category: 16 x u8 canonical code lengths
      direct:   vmin i32, alphabet_size u16, (alphabet_size + 1) x u8 lengths
                (last = ESC)
      none:     (empty)
    coded_runs only: 65 x u8 canonical run-code lengths (runs 0..64)
    adaptive only: bh*bw x u8 per-block variance codes (padded grid dims)
    n_stripes x u32 stripe bit lengths
    decode_index only (flags2 bit0): per-block bit lengths in
      stripe-linear block order — the restart-marker analog (the
      reference has no bitstream at all, SURVEY.md B2): it makes every
      block an independently addressable substream, which is what the
      device entropy decoder parallelizes over
      (ops/entropy_decode.py). Two encodings:
        * flags2 bit1 set (all new containers): u8 width w (1..16), then
          ceil(n_blocks*w/8) bytes of MSB-first w-bit entries, pad bits
          zero — w is the smallest width the plane's largest block
          needs, which cuts the index ~40-50% vs u16 at photographic
          qualities;
        * bit1 clear (legacy round-4 v2): n_blocks x u16.
      Each stripe's sum must equal its stripe_bits entry — validated on
      read.
    payload: concatenation of byte-aligned stripe substreams

With cfg.decode_index == "auto" (the default), serialize() includes the
index only when its packed bytes are <= AUTO_INDEX_BOUND of the payload
bytes — device decode on the default path exactly where the size cost
is small (measured table: benchmarks/index_cost.py, BASELINE.md r5).
The decision depends only on the plane bytes, so it is deterministic
and mesh-shape-invariant like everything else on the wire.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from dct_tpu.config import CodecConfig

MAGIC = b"TPDC"
VERSION = 1
VERSION_EXT = 2  # adds the flags2 byte (bit0: decode_index, bit1: packed)

# "auto" decode_index includes the packed index only when it costs at
# most this fraction of the payload bytes. From the measured table
# (benchmarks/index_cost.py): packed ~13% at q50, ~4% at q90, ~2% at
# q97 on the real-image set — 6% turns device decode on for
# high-quality content and leaves small/low-quality payloads alone.
AUTO_INDEX_BOUND = 0.06

_HUFFMAN_MODES = ("category", "direct", "none")
_CHROMA_MODES = ("gray", "444", "420")


def _index_width(bb: np.ndarray) -> int:
    """Smallest per-entry bit width for a block-bits index."""
    return max(1, int(bb.max(initial=0)).bit_length())


def pack_index(bb: np.ndarray) -> tuple[int, bytes]:
    """(width, MSB-first packed entries + zero pad bits)."""
    bb = np.asarray(bb, np.int64)
    w = _index_width(bb)
    bits = np.zeros(bb.size * w, np.uint8)
    for k in range(w):
        bits[k::w] = (bb >> (w - 1 - k)) & 1
    return w, np.packbits(bits).tobytes()


def _unpack_index(data: bytes, off: int, n: int, w: int) -> np.ndarray:
    nbytes = (n * w + 7) // 8
    raw = np.frombuffer(data, np.uint8, nbytes, off)
    bits = np.unpackbits(raw)
    if bits[n * w:].any():
        raise ValueError("decode index pad bits not zero")
    vals = np.zeros(n, np.int64)
    for k in range(w):
        vals = (vals << 1) | bits[k::w][:n]
    return vals.astype(np.uint16)


def index_cost_bytes(planes: "list[PlaneData]") -> int:
    """Wire bytes the packed decode index would add (width bytes incl.)."""
    return sum(
        1 + (p.block_bits.size * _index_width(p.block_bits) + 7) // 8
        for p in planes
    )


def _resolve_decode_index(c: "Container") -> bool:
    """Concrete include-the-index decision for this container.

    Payload bytes come from stripe_bits (the wire-recorded per-stripe
    lengths), NOT len(stripes): identical for real containers, and it
    keeps the rate-control size probes exact — their skeletons carry
    real stripe_bits/block_bits over empty stripe buffers."""
    di = c.config.decode_index
    if di != "auto":
        return bool(di)
    if any(p.block_bits is None for p in c.planes):
        return False
    payload = sum(
        int(((np.asarray(p.stripe_bits, np.int64) + 7) // 8).sum())
        for p in c.planes
    )
    return payload > 0 and index_cost_bytes(c.planes) <= (
        AUTO_INDEX_BOUND * payload
    )


@dataclasses.dataclass
class PlaneData:
    width: int
    height: int
    table_lengths: np.ndarray | None  # canonical code lengths (or None)
    vmin: int  # direct mode only
    variance_codes: np.ndarray | None  # (bh*bw,) u8, adaptive only
    stripe_bits: np.ndarray  # (n_stripes,) u32
    stripes: list[bytes]
    run_table_lengths: np.ndarray | None = None  # coded_runs only, 65 x u8
    # (canonical code length for each run 0..64 — 64 is the all-zero-block
    # terminal symbol, see ops/rle.py)
    block_bits: np.ndarray | None = None  # decode_index only:
    # (n_stripes * blocks_per_stripe,) u16 per-block bit lengths in
    # stripe-linear block order


@dataclasses.dataclass
class Container:
    config: CodecConfig
    width: int
    height: int
    planes: list[PlaneData]


def _pack_flags(cfg: CodecConfig) -> int:
    return (
        (1 if cfg.adaptive else 0)
        | ((1 if cfg.use_huffman else 0) << 1)
        | (_HUFFMAN_MODES.index(cfg.huffman_mode) << 2)
        | ((1 if cfg.compat_b1 else 0) << 4)
        | ((1 if cfg.static_tables else 0) << 5)
        | ((1 if cfg.coded_runs else 0) << 6)
        | ((1 if cfg.dc_prediction else 0) << 7)
    )


def serialize(c: Container) -> bytes:
    cfg = c.config
    with_index = _resolve_decode_index(c)
    out = bytearray()
    out += MAGIC
    out += struct.pack(
        "<BBBBIIBBH",
        VERSION_EXT if with_index else VERSION,
        _pack_flags(cfg),
        cfg.block_size,
        cfg.quality,
        c.width,
        c.height,
        len(c.planes),
        _CHROMA_MODES.index(cfg.chroma),
        cfg.stripe_rows,
    )
    if with_index:
        out += struct.pack("<B", 0b11)  # flags2: index present, packed
    for p in c.planes:
        out += struct.pack("<III", p.width, p.height, len(p.stripes))
        mode = cfg.huffman_mode if cfg.use_huffman else "none"
        if mode == "category":
            # wire-format invariants raise (not assert): `python -O` strips
            # asserts and would silently serialize an undecodable container
            if len(p.table_lengths) != 16:
                raise ValueError(
                    f"category table must have 16 lengths, got "
                    f"{len(p.table_lengths)}"
                )
            out += bytes(np.asarray(p.table_lengths, np.uint8))
        elif mode == "direct":
            lengths = np.asarray(p.table_lengths, np.uint8)
            out += struct.pack("<iH", p.vmin, len(lengths) - 1)
            out += bytes(lengths)
        if cfg.coded_runs:
            if len(p.run_table_lengths) != 65:
                raise ValueError(
                    f"run table must have 65 lengths (runs 0..64), got "
                    f"{len(p.run_table_lengths)}"
                )
            out += bytes(np.asarray(p.run_table_lengths, np.uint8))
        if cfg.adaptive:
            out += bytes(np.asarray(p.variance_codes, np.uint8))
        out += np.asarray(p.stripe_bits, "<u4").tobytes()
        if with_index:
            bb = np.asarray(p.block_bits, np.int64)
            n_stripes = len(p.stripes)
            if bb.size % n_stripes:
                raise ValueError(
                    f"decode index size {bb.size} not divisible by "
                    f"{n_stripes} stripes"
                )
            per = bb.reshape(n_stripes, -1).sum(axis=1)
            if not np.array_equal(per, np.asarray(p.stripe_bits, np.int64)):
                raise ValueError(
                    "decode index stripe sums disagree with stripe_bits"
                )
            if bb.max(initial=0) > 0xFFFF or bb.min(initial=0) < 0:
                raise ValueError("per-block bit length outside u16")
            w, packed = pack_index(bb)
            out += struct.pack("<B", w)
            out += packed
        for s in p.stripes:
            out += s
    return bytes(out)


def deserialize(data: bytes) -> Container:
    if data[:4] != MAGIC:
        raise ValueError("not a TPDC container")
    try:
        return _deserialize(data)
    except (struct.error, ValueError) as e:
        # struct/frombuffer overruns = truncated file; surface uniformly
        raise ValueError(f"truncated or corrupt TPDC container: {e}") from e


def _deserialize(data: bytes) -> Container:
    (
        version,
        flags,
        block_size,
        quality,
        width,
        height,
        n_planes,
        chroma_idx,
        stripe_rows,
    ) = struct.unpack_from("<BBBBIIBBH", data, 4)
    if version not in (VERSION, VERSION_EXT):
        raise ValueError(f"unsupported container version {version}")
    flags2 = 0
    header_end = 20
    if version >= VERSION_EXT:
        (flags2,) = struct.unpack_from("<B", data, 20)
        header_end = 21
        if flags2 & ~3:
            raise ValueError(f"unknown extension flags 0x{flags2:02x}")
        if flags2 & 2 and not flags2 & 1:
            raise ValueError("packed-index flag without an index")
    decode_index = bool(flags2 & 1)
    packed_index = bool(flags2 & 2)
    # validate enum/structural header fields BEFORE using them — corrupt
    # values must surface as the uniform ValueError, not ZeroDivisionError
    # (stripe_rows=0) or IndexError (mode indexes)
    if stripe_rows < 1:
        raise ValueError(f"invalid stripe_rows {stripe_rows}")
    if block_size < 2:
        raise ValueError(f"invalid block_size {block_size}")
    huffman_idx = (flags >> 2) & 3
    if huffman_idx >= len(_HUFFMAN_MODES):
        raise ValueError(f"invalid huffman mode index {huffman_idx}")
    if chroma_idx >= len(_CHROMA_MODES):
        raise ValueError(f"invalid chroma mode index {chroma_idx}")
    expected_planes = 1 if _CHROMA_MODES[chroma_idx] == "gray" else 3
    if n_planes != expected_planes:
        raise ValueError(
            f"chroma mode {_CHROMA_MODES[chroma_idx]!r} requires "
            f"{expected_planes} planes, header says {n_planes}"
        )
    cfg = CodecConfig(
        block_size=block_size,
        quality=quality,
        adaptive=bool(flags & 1),
        use_huffman=bool((flags >> 1) & 1),
        huffman_mode=_HUFFMAN_MODES[huffman_idx],
        compat_b1=bool((flags >> 4) & 1),
        static_tables=bool((flags >> 5) & 1),
        coded_runs=bool((flags >> 6) & 1),
        dc_prediction=bool((flags >> 7) & 1),
        chroma=_CHROMA_MODES[chroma_idx],
        stripe_rows=stripe_rows,
        decode_index=decode_index,
    )
    off = header_end
    planes = []
    n = block_size
    for _ in range(n_planes):
        pw, ph, n_stripes = struct.unpack_from("<III", data, off)
        off += 12
        # geometry consistency: the stored stripe count must match the
        # plane dims + stripe_rows (a corrupt header otherwise crashes the
        # decoder far downstream with a shape error)
        bh_exp = -(-ph // n)
        bh_exp = -(-bh_exp // stripe_rows) * stripe_rows
        if ph == 0 or pw == 0 or n_stripes != bh_exp // stripe_rows:
            raise ValueError(
                f"inconsistent plane geometry: {pw}x{ph} with "
                f"stripe_rows={stripe_rows} implies "
                f"{bh_exp // max(stripe_rows, 1)} stripes, header says "
                f"{n_stripes}"
            )
        mode = cfg.huffman_mode if cfg.use_huffman else "none"
        table = None
        vmin = 0
        if mode == "category":
            table = np.frombuffer(data, np.uint8, 16, off).copy()
            off += 16
        elif mode == "direct":
            vmin, alpha = struct.unpack_from("<iH", data, off)
            off += 6
            table = np.frombuffer(data, np.uint8, alpha + 1, off).copy()
            off += alpha + 1
        run_table = None
        if cfg.coded_runs:
            run_table = np.frombuffer(data, np.uint8, 65, off).copy()
            off += 65
        var_codes = None
        if cfg.adaptive:
            # grid dims after padding to stripe multiples (codec.py contract)
            bh = -(-ph // n)
            bh = -(-bh // stripe_rows) * stripe_rows
            bw = -(-pw // n)
            var_codes = np.frombuffer(data, np.uint8, bh * bw, off).copy()
            off += bh * bw
        stripe_bits = np.frombuffer(data, "<u4", n_stripes, off).copy()
        off += 4 * n_stripes
        block_bits = None
        if decode_index:
            bh = -(-ph // n)
            bh = -(-bh // stripe_rows) * stripe_rows
            bw = -(-pw // n)
            bps = stripe_rows * bw  # blocks per stripe (padded grid)
            if packed_index:
                (w,) = struct.unpack_from("<B", data, off)
                off += 1
                if not 1 <= w <= 16:
                    raise ValueError(f"invalid decode index width {w}")
                block_bits = _unpack_index(data, off, n_stripes * bps, w)
                off += (n_stripes * bps * w + 7) // 8
            else:  # legacy round-4 v2: raw u16 entries
                block_bits = np.frombuffer(
                    data, "<u2", n_stripes * bps, off
                ).copy()
                off += 2 * n_stripes * bps
            per = block_bits.astype(np.int64).reshape(n_stripes, bps).sum(1)
            if not np.array_equal(per, stripe_bits.astype(np.int64)):
                # a hostile/corrupt index would misaddress every block the
                # device decoder touches — reject up front, like the other
                # geometry checks
                raise ValueError(
                    "decode index stripe sums disagree with stripe_bits"
                )
        stripes = []
        for s in range(n_stripes):
            nbytes = int((int(stripe_bits[s]) + 7) // 8)
            if off + nbytes > len(data):
                raise ValueError(
                    f"stripe {s} payload extends past end of data "
                    f"({off + nbytes} > {len(data)})"
                )
            stripes.append(data[off : off + nbytes])
            off += nbytes
        planes.append(
            PlaneData(
                run_table_lengths=run_table,
                width=pw,
                height=ph,
                table_lengths=table,
                vmin=vmin,
                variance_codes=var_codes,
                stripe_bits=stripe_bits,
                stripes=stripes,
                block_bits=block_bits,
            )
        )
    return Container(config=cfg, width=width, height=height, planes=planes)


# ---------------------------------------------------------------------------
# Stream files: many per-frame containers in one .tpdv file
# ---------------------------------------------------------------------------

VIDEO_MAGIC = b"TPDV"


def serialize_streams(streams: list[bytes]) -> bytes:
    """Concatenate per-frame TPDC containers into one seekable stream file.

    Layout: magic, u32 frame count, u32 sizes table, then the containers
    back to back. The sizes table gives random access to any frame without
    parsing the others (mirrors the per-stripe offsets table inside each
    container, one level up)."""
    out = bytearray()
    out += VIDEO_MAGIC
    out += struct.pack("<I", len(streams))
    out += np.asarray([len(s) for s in streams], "<u4").tobytes()
    for s in streams:
        out += s
    return bytes(out)


def deserialize_streams(data: bytes) -> list[bytes]:
    """Stream file -> list of per-frame TPDC container bytes."""
    if data[:4] != VIDEO_MAGIC:
        raise ValueError("not a TPDV stream file")
    if len(data) < 8:
        raise ValueError("truncated TPDV header")
    (count,) = struct.unpack_from("<I", data, 4)
    table_end = 8 + 4 * count
    if len(data) < table_end:
        raise ValueError("truncated TPDV sizes table")
    sizes = np.frombuffer(data[8:table_end], "<u4")
    if table_end + int(sizes.sum()) > len(data):
        raise ValueError("truncated TPDV payload")
    out = []
    pos = table_end
    for n in sizes:
        out.append(data[pos : pos + int(n)])
        pos += int(n)
    return out
