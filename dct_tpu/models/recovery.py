"""Per-stripe integrity, repair, and random-access decode.

SURVEY.md sections 5.3/5.4: the reference has no failure handling or
serialization at all (its only failure mode is exit() on malloc failure,
utils.c:12); in this framework the TPDC container's per-stripe independent
substreams ARE the checkpoint/recovery unit. This module turns that design
property into user-facing operations:

  * verify(data)        — integrity scan: entropy-decode every stripe
                          independently and check it against the recorded
                          bit length (a decode that raises, overruns, or
                          consumes a different number of bits than the
                          container records is corrupt).
  * repair(data, src)   — re-encode ONLY the damaged stripes from the
                          source image and splice them in. Byte-identical
                          to a from-scratch encode (tested) because stripe
                          substreams share no state: this is the
                          resume-after-failure story — an interrupted or
                          partially corrupted encode never redoes finished
                          stripes.
  * decode_region(data, row0, row1)
                        — random access: decode only the stripes that
                          overlap a row range (seek/parallel consumers).

Color containers are covered plane-wise: every plane's stripes are
independent substreams, so verify/repair address them as (plane, stripe)
pairs and repair reproduces the per-plane encode (Y against the luma quant
table, Cb/Cr against the chrominance table on the subsampled grid) exactly.
Grayscale containers keep the original flat stripe-index API.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from dct_tpu import container as cont
from dct_tpu.config import CodecConfig
from dct_tpu.models import codec
from dct_tpu.ops import bitstream as bs
from dct_tpu.ops import blocks as blk
from dct_tpu.ops import huffman as hf
from dct_tpu.ops import quant, rle, transform


def _is_gray(c: cont.Container) -> bool:
    return c.config.chroma == "gray"


def _geometry(p: cont.PlaneData, cfg: CodecConfig):
    bh, bw, n_stripes = codec._padded_grid(p.height, p.width, cfg)
    bps = (bh // n_stripes) * bw  # blocks per stripe
    return bh, bw, n_stripes, bps


def _table(p: cont.PlaneData, cfg: CodecConfig):
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    t = hf.CanonicalTable(p.table_lengths) if mode != "none" else None
    run_t = (
        hf.CanonicalTable(p.run_table_lengths) if cfg.coded_runs else None
    )
    return mode, t, run_t


def _verify_plane(p: cont.PlaneData, cfg: CodecConfig) -> list[int]:
    from dct_tpu import native

    _, _, n_stripes, bps = _geometry(p, cfg)
    mode, table, run_table = _table(p, cfg)
    if native.available():
        status = native.verify_stripes(
            p.stripes, bps, cfg.n2, mode, table, p.vmin,
            np.asarray(p.stripe_bits, np.uint32), run_table=run_table,
        )
        return [int(s) for s in np.nonzero(status)[0]]
    bad = []
    for s in range(n_stripes):
        try:
            bs.unpack_stripe_host(
                p.stripes[s], bps, cfg.n2, mode,
                cat_table=table if mode == "category" else None,
                val_table=table if mode == "direct" else None,
                vmin=p.vmin,
                expected_bits=int(p.stripe_bits[s]),
                run_table=run_table,
            )
        except (ValueError, IndexError):
            bad.append(s)
    return bad


def verify(data: bytes) -> list:
    """Scan a container; return the corrupt stripes.

    A stripe is corrupt if its entropy decode raises (invalid Huffman
    code, buffer overrun) or consumes a bit count different from the one
    the container records — the position-invariant decoder consumes an
    exact, content-determined number of bits, so byte damage almost
    surely desynchronizes it.

    Grayscale containers return flat stripe indices (list[int]); color
    containers return (plane_index, stripe_index) tuples.
    """
    c = cont.deserialize(data)
    cfg = c.config
    if _is_gray(c):
        return _verify_plane(c.planes[0], cfg)
    return [
        (pi, s)
        for pi, p in enumerate(c.planes)
        for s in _verify_plane(p, cfg)
    ]


def _padded_plane(image: np.ndarray, cfg: CodecConfig) -> jnp.ndarray:
    """Reproduce encode_plane's padding exactly (edge mode to the
    stripe-aligned block grid)."""
    h, w = int(image.shape[0]), int(image.shape[1])
    bh, bw, _ = codec._padded_grid(h, w, cfg)
    n = cfg.block_size
    img = blk.pad_to_blocks(jnp.asarray(np.asarray(image, np.uint8)), n)
    ph, pw = bh * n, bw * n
    if img.shape[0] != ph or img.shape[1] != pw:
        img = jnp.pad(
            img, ((0, ph - img.shape[0]), (0, pw - img.shape[1])), mode="edge"
        )
    return img


def _encode_one_stripe(
    rows: jnp.ndarray,
    cfg: CodecConfig,
    table: hf.CanonicalTable | None,
    run_table: hf.CanonicalTable | None = None,
    chroma: bool = False,
):
    """Encode one stripe's pixel rows against FIXED tables (the
    container's — never rebuilt from the stripe's own histograms, or a
    dynamic-table repair would drift from the original encode)."""
    pixels = blk.image_to_blocks(rows, cfg.block_size)
    var_codes = None
    scale = None
    if cfg.adaptive:
        var = quant.block_variance_flat(transform.level_shift(pixels))
        var_codes = quant.variance_code(var)
        scale = quant.scale_from_variance_code(var_codes)
    zz = transform.encode_blocks(
        pixels, cfg, adaptive_scale=scale, chroma=chroma
    )
    if cfg.dc_prediction:
        zz = codec.dc_predict(zz, 1)
    symbols = rle.rle_encode_positional(zz)
    lengths, codes = codec._table_arrays(table)
    if cfg.coded_runs:
        run_lengths, run_codes = codec._table_arrays(run_table)
    else:
        run_lengths = run_codes = None
    out = codec.encode_pack(
        symbols, cfg, 1, lengths, codes, run_lengths, run_codes,
        return_block_bits=bool(cfg.decode_index),
    )
    if cfg.decode_index:
        packed, block_bits = out
        return packed, var_codes, block_bits
    return out, var_codes, None


def _repair_plane(
    p: cont.PlaneData,
    cfg: CodecConfig,
    source_plane: np.ndarray,
    stripes: list[int],
    chroma: bool,
) -> cont.PlaneData:
    if source_plane.shape != (p.height, p.width):
        raise ValueError(
            f"source {source_plane.shape} != container plane "
            f"{(p.height, p.width)}"
        )
    _, bw, n_stripes, bps = _geometry(p, cfg)
    _, table, run_table = _table(p, cfg)
    img = _padded_plane(source_plane, cfg)
    n = cfg.block_size
    rows_per_stripe = cfg.stripe_rows * n

    stripe_bits = np.asarray(p.stripe_bits, np.uint32).copy()
    new_stripes = list(p.stripes)
    var_codes = (
        np.asarray(p.variance_codes, np.uint8).copy() if cfg.adaptive else None
    )
    block_bits = (
        np.asarray(p.block_bits, np.uint16).copy()
        if p.block_bits is not None else None
    )
    for s in stripes:
        if not 0 <= s < n_stripes:
            raise ValueError(f"stripe {s} out of range (n_stripes={n_stripes})")
        rows = img[s * rows_per_stripe : (s + 1) * rows_per_stripe]
        packed, vc, bb = _encode_one_stripe(rows, cfg, table, run_table, chroma)
        packed = bs.fetch_packed(packed)  # trim worst-case slack, as encode
        new_stripes[s] = bs.stripes_to_bytes(packed)[0]
        stripe_bits[s] = int(packed.bit_lengths[0])
        if cfg.adaptive:
            var_codes[s * bps : (s + 1) * bps] = np.asarray(vc, np.uint8)
        if block_bits is not None:
            block_bits[s * bps : (s + 1) * bps] = np.asarray(
                bb, np.int64
            ).reshape(-1).astype(np.uint16)

    return cont.PlaneData(
        width=p.width,
        height=p.height,
        table_lengths=p.table_lengths,
        vmin=p.vmin,
        variance_codes=var_codes,
        stripe_bits=stripe_bits,
        stripes=new_stripes,
        run_table_lengths=p.run_table_lengths,
        block_bits=block_bits,
    )


def _source_planes(c: cont.Container, source: np.ndarray) -> list[np.ndarray]:
    """Reproduce the encoder's source->plane mapping (models/color.py
    _to_planes for color; identity for grayscale)."""
    if _is_gray(c):
        if source.ndim != 2:
            raise ValueError(f"expected (H, W) source, got {source.shape}")
        return [np.asarray(source, np.uint8)]
    if source.ndim != 3 or source.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) RGB source, got {source.shape}")
    from dct_tpu.models import color as _color

    y, cb, cr = _color._to_planes(
        jnp.asarray(source, jnp.uint8), c.config.chroma
    )
    return [np.asarray(y), np.asarray(cb), np.asarray(cr)]


def repair(
    data: bytes, source: np.ndarray, stripes: list | None = None
) -> bytes:
    """Re-encode the given (default: auto-detected corrupt) stripes of a
    container from the source image and return the repaired container.

    Byte-identical to a from-scratch encode of the source under the
    container's config (per-stripe substream independence). Grayscale
    containers address stripes by flat index; color containers by
    (plane_index, stripe_index) pairs — both as verify() reports them."""
    c = cont.deserialize(data)
    cfg = c.config
    # validate the source BEFORE the nothing-to-repair short-circuit: a
    # wrong source must never be reported as a successful (no-op) repair
    want_shape = (
        (c.height, c.width) if _is_gray(c) else (c.height, c.width, 3)
    )
    if tuple(source.shape) != want_shape:
        raise ValueError(
            f"source {source.shape} != container image {want_shape}"
        )
    if stripes is None:
        stripes = verify(data)
    if not stripes:
        return data
    planes_src = _source_planes(c, source)
    if _is_gray(c):
        per_plane = {0: list(stripes)}
    else:
        per_plane = {}
        for pi, s in stripes:
            per_plane.setdefault(pi, []).append(s)
        if any(not 0 <= pi < len(c.planes) for pi in per_plane):
            raise ValueError(f"plane index out of range in {sorted(per_plane)}")
    new_planes = [
        _repair_plane(p, cfg, planes_src[pi], per_plane[pi], chroma=pi > 0)
        if pi in per_plane
        else p
        for pi, p in enumerate(c.planes)
    ]
    return cont.serialize(
        cont.Container(
            config=cfg, width=c.width, height=c.height, planes=new_planes
        )
    )


def rebuild(template: bytes, source: np.ndarray) -> bytes:
    """Re-encode EVERY stripe of `source` against a template container's
    config and entropy tables.

    The repair story for a frame whose own header/tables were destroyed:
    in a batch (video stream file) every frame carries the same tables, so
    a readable sibling frame serves as the template and the rebuilt frame
    is byte-identical to the lost original."""
    c = cont.deserialize(template)
    if _is_gray(c):
        _, _, n_stripes, _ = _geometry(c.planes[0], c.config)
        all_stripes: list = list(range(n_stripes))
    else:
        all_stripes = [
            (pi, s)
            for pi, p in enumerate(c.planes)
            for s in range(len(p.stripes))
        ]
    return repair(template, source, stripes=all_stripes)


def decode_region(data: bytes, row0: int, row1: int) -> np.ndarray:
    """Decode only pixel rows [row0, row1) — entropy-decodes just the
    stripes overlapping the range (random access / parallel consumers).

    Color containers return (rows, W, 3) RGB: the luma rows plus the
    chroma rows covering them (half-rate for 4:2:0) are decoded and
    recombined exactly as the full decoder would."""
    c = cont.deserialize(data)
    cfg = c.config
    if not 0 <= row0 < row1 <= c.height:
        raise ValueError(f"bad row range [{row0}, {row1}) for height {c.height}")
    if _is_gray(c):
        return _decode_plane_region(c.planes[0], cfg, row0, row1, False)

    from dct_tpu.models import color as _color

    y = _decode_plane_region(c.planes[0], cfg, row0, row1, False)
    if cfg.chroma == "444":
        cb = _decode_plane_region(c.planes[1], cfg, row0, row1, True)
        cr = _decode_plane_region(c.planes[2], cfg, row0, row1, True)
    else:  # 420: pixel row r draws from chroma row r//2 (nearest-neighbor)
        ch = c.planes[1].height
        c0, c1 = row0 // 2, min(-(-row1 // 2), ch)
        cbs = _decode_plane_region(c.planes[1], cfg, c0, c1, True)
        crs = _decode_plane_region(c.planes[2], cfg, c0, c1, True)

        def up(x):
            x = np.repeat(np.repeat(x, 2, axis=0), 2, axis=1)
            return x[row0 - 2 * c0 : row1 - 2 * c0, : c.width]

        cb, cr = up(cbs), up(crs)
    ycc = jnp.stack([
        jnp.asarray(y, jnp.float32),
        jnp.asarray(cb, jnp.float32),
        jnp.asarray(cr, jnp.float32),
    ], axis=-1)
    return np.asarray(_color.ycbcr_to_rgb(ycc))


def _decode_plane_region(
    p: cont.PlaneData, cfg: CodecConfig, row0: int, row1: int, chroma: bool
) -> np.ndarray:
    if not 0 <= row0 < row1 <= p.height:
        raise ValueError(f"bad row range [{row0}, {row1}) for height {p.height}")
    _, bw, n_stripes, bps = _geometry(p, cfg)
    mode, table, run_table = _table(p, cfg)
    n = cfg.block_size
    rows_per_stripe = cfg.stripe_rows * n
    s0 = row0 // rows_per_stripe
    s1 = -(-row1 // rows_per_stripe)
    s1 = min(s1, n_stripes)

    zz = np.concatenate(
        [
            bs.unpack_stripe_host(
                p.stripes[s], bps, cfg.n2, mode,
                cat_table=table if mode == "category" else None,
                val_table=table if mode == "direct" else None,
                vmin=p.vmin,
                run_table=run_table,
            )
            for s in range(s0, s1)
        ],
        axis=0,
    )
    if cfg.dc_prediction:
        zz = codec.dc_reconstruct(zz, s1 - s0)
    scale = None
    if cfg.adaptive:
        codes = jnp.asarray(p.variance_codes[s0 * bps : s1 * bps])
        scale = quant.scale_from_variance_code(codes)
    pixels = transform.decode_blocks(
        jnp.asarray(zz), cfg, adaptive_scale=scale, chroma=chroma
    )
    img = blk.blocks_to_image(
        pixels, (s1 - s0) * rows_per_stripe, bw * n, n
    )
    base = s0 * rows_per_stripe
    return np.asarray(img[row0 - base : row1 - base, : p.width])
