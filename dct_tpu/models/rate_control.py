"""Rate-distortion control: encode to a byte budget or a PSNR target by
probing EXACT container sizes / distortions on device.

The reference ships an encoded-size ESTIMATOR (`get_encoded_size`,
entropy.c:363-399 — SURVEY.md section 2 component 11) but never closes the
loop into rate control. This module does, on the device: a size probe is the
staged encode pipeline run WITHOUT the bit-pack — device transform + RLE +
symbol chunk lengths reduced to one int32 per stripe — so probing a
quality costs one analyze dispatch (+ one chunk-length dispatch for
dynamic tables) and fetches n_stripes ints instead of a payload. Probe
sizes are EXACT, not estimates: the chunk-length tensor is the same one
the packer offsets by (ops/bitstream.symbol_chunks), and the header cost
comes from serializing an empty-stripe skeleton container, so the
prediction cannot drift from the wire format (asserted byte-exact against
real encodes in tests/test_rate_control.py). Distortion probes run the
production quantize/reconstruct pair and are integer-exact against a real
encode+decode roundtrip.

`encode_to_size` / `encode_to_psnr` / `encode_video_to_size` bisect a
quality ladder for the best rung, then run ONE real encode. Size and PSNR
are near-monotone in quality; bisection can in principle settle on a
suboptimal feasible rung on adversarial content, but the returned encode
always satisfies the constraint because each probe is exact for its own
quality.

Deliberately NOT batched across the ladder: stacking the per-quality
operators into one vmapped dispatch would re-derive the transform outside
the canonical per-quality constants (transform.packed_encode_operator_
split), risking an f32 tie-rounding divergence from the real encode — a
silently-wrong size is worse than a few extra dispatches per image.
Probes are jit-cached per (quality, shape), so repeated calls pay
dispatches only.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from dct_tpu import container as cont
from dct_tpu.config import CodecConfig
from dct_tpu.models import codec as _codec
from dct_tpu.ops import blocks as blk
from dct_tpu.ops import transform

# Quality rungs for the encode_to_* ladders: dense where the size/quality
# curve is steep (high quality), sparse where it is flat.
DEFAULT_LADDER = (1, 5, 10, 15, 20, 30, 40, 50, 60, 70, 80, 85, 90, 95, 97, 100)


def _normalize_chroma(ndim: int, cfg: CodecConfig) -> CodecConfig:
    """Apply codec.encode's rank-based chroma rules up front: RGB input
    with chroma='gray' switches to '420' (codec.py encode()); grayscale
    input with a color chroma is rejected HERE, before any probe work,
    with the same meaning as ImageCodec's own rejection."""
    if ndim == 3:
        return cfg.replace(chroma="420") if cfg.chroma == "gray" else cfg
    if cfg.chroma != "gray":
        raise ValueError(
            "grayscale (H, W) input requires chroma='gray' "
            f"(config has {cfg.chroma!r})"
        )
    return cfg


# the probes MUST pad exactly as the encoder does — one shared
# implementation (codec.pad_plane_for_encode), not a mirror
_pad_plane = _codec.pad_plane_for_encode


def _plane_roundtrip(
    plane_padded: jax.Array, cfg: CodecConfig, chroma: bool
) -> jax.Array:
    """Quantize + reconstruct one padded plane with the production
    transform pair (the ops decode_plane_device executes — the wire
    carries these exact integers), returning the reconstructed padded
    plane. Shared by the grayscale and RGB SSE kernels."""
    n = cfg.block_size
    pixels = blk.image_to_blocks(plane_padded, n)
    scale = None
    if cfg.adaptive:
        from dct_tpu.ops import quant

        var = quant.block_variance_flat(transform.level_shift(pixels))
        scale = quant.scale_from_variance_code(quant.variance_code(var))
    zz = transform.encode_blocks(
        pixels, cfg, adaptive_scale=scale, chroma=chroma
    )
    rec = transform.decode_blocks(
        zz, cfg, adaptive_scale=scale, chroma=chroma
    )
    return blk.blocks_to_image(
        rec, plane_padded.shape[0], plane_padded.shape[1], n
    )


def _ladder_bisect(
    ladder: list[int],
    meets: Callable[[int], bool],
    strict: bool,
    fail_msg: Callable[[int], str],
) -> int:
    """Largest ladder value satisfying `meets`, assuming `meets` is
    (near-)monotone true -> false along the ladder. If even ladder[0]
    fails: raise ValueError(fail_msg) when strict, else return ladder[0]
    (best effort). Shared by all three encode_to_* fronts — the PSNR
    front passes a descending ladder so 'largest satisfying index' means
    'lowest satisfying quality'."""
    lo, hi = 0, len(ladder) - 1
    if not meets(ladder[lo]):
        if strict:
            raise ValueError(fail_msg(ladder[lo]))
        return ladder[lo]
    if meets(ladder[hi]):
        return ladder[hi]
    # invariant: ladder[lo] satisfies, ladder[hi] does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if meets(ladder[mid]):
            lo = mid
        else:
            hi = mid
    return ladder[lo]


def _clean_ladder(qualities) -> list[int]:
    if not qualities:
        raise ValueError("empty quality ladder")
    return sorted(set(int(q) for q in qualities))


# ---------------------------------------------------------------------------
# Size probes (exact container bytes without packing)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "n_stripes"))
def _chunk_bits(
    symbols,
    cfg: CodecConfig,
    n_stripes: int,
    lengths: jax.Array,
    codes: jax.Array,
    run_lengths: jax.Array | None = None,
    run_codes: jax.Array | None = None,
):
    """(per-stripe, per-block) payload bit counts: encode_pack minus the
    pack.

    Reduces the same (B, S, 3) chunk-length tensor the scatter packer
    consumes — via codec.symbol_chunks_for, the SAME dispatch
    encode_pack calls, so the equality is structural, not a mirror. The
    per-BLOCK counts feed the probe skeleton's decode index: the packed
    index width (and hence the container size, and the "auto" include
    decision) depends on the actual values, not just the block count."""
    _, cl = _codec.symbol_chunks_for(
        symbols, cfg, lengths, codes, run_lengths, run_codes
    )
    bb = cl.reshape(cl.shape[0], -1).sum(axis=1)  # (NB,)
    return bb.reshape(n_stripes, -1).sum(axis=1), bb


def _probe_skeleton(
    w: int, h: int, cfg: CodecConfig, n_stripes: int, table, run_table,
    var_codes, stripe_bits, block_bits,
) -> cont.PlaneData:
    """Empty-stripe PlaneData carrying exactly the probe-relevant header
    fields, so serializing it prices the per-plane overhead byte-exactly.
    stripe_bits/block_bits are the REAL probed counts: the packed decode
    index's width — and serialize()'s "auto" include decision, which
    reads payload bytes off stripe_bits — are value-dependent."""
    return cont.PlaneData(
        width=w,
        height=h,
        table_lengths=table.lengths if table is not None else None,
        vmin=_codec.DIRECT_VMIN,
        variance_codes=var_codes,
        stripe_bits=np.asarray(stripe_bits, np.uint32),
        stripes=[b""] * n_stripes,
        run_table_lengths=(
            run_table.lengths if run_table is not None else None
        ),
        block_bits=(
            np.asarray(block_bits).reshape(-1).astype(np.uint16)
            if cfg.decode_index and block_bits is not None else None
        ),
    )


def _plane_size(
    plane: np.ndarray, cfg: CodecConfig, chroma: bool, mesh=None
) -> tuple[np.ndarray, cont.PlaneData]:
    """(per-stripe bit counts, empty-stripe PlaneData skeleton) for one
    plane at cfg.quality. Mirrors codec.encode_plane up to (but not
    including) the pack stage. With a mesh, the analyze + chunk-length
    reduction runs sharded over the stripe axis with the same psum table
    globalization as parallel/shard_encode.encode_plane_sharded — the
    counts are mesh-shape-invariant and equal to the unsharded probe's."""
    h, w = int(plane.shape[0]), int(plane.shape[1])
    _, _, n_stripes = _codec._padded_grid(h, w, cfg)

    if mesh is not None:
        from dct_tpu.parallel import shard_encode as _se

        bits, bb, vc, table, run_table = _se.plane_probe_bits_sharded(
            plane, cfg, mesh, chroma=chroma
        )
        return bits, _probe_skeleton(
            w, h, cfg, n_stripes, table, run_table,
            vc if cfg.adaptive else None, bits, bb,
        )

    img = _pad_plane(plane, cfg)
    symbols, var_codes, hist, run_hist = _codec.encode_analyze(
        img, cfg, chroma=chroma
    )
    table = _codec._build_table(
        cfg, None if cfg.static_tables else np.asarray(hist)
    )
    run_table = _codec._build_run_table(
        cfg, None if cfg.static_tables else np.asarray(run_hist)
    )
    lengths, codes = _codec._table_arrays(table)
    if cfg.coded_runs:
        run_lengths, run_codes = _codec._table_arrays(run_table)
    else:
        run_lengths = run_codes = None
    bits, bb = _chunk_bits(
        symbols, cfg, n_stripes, lengths, codes, run_lengths, run_codes
    )
    bits = np.asarray(bits)
    return bits, _probe_skeleton(
        w, h, cfg, n_stripes, table, run_table,
        np.asarray(var_codes) if cfg.adaptive else None,
        bits, np.asarray(bb),
    )


def _image_plane_args(
    image: np.ndarray, cfg: CodecConfig
) -> list[tuple[np.ndarray, bool]]:
    """Image -> [(plane, is_chroma)] under an already-normalized cfg. The
    RGB->YCbCr split is quality-independent, so encode_to_size builds
    this once and probes every rung against it."""
    if image.ndim == 2:
        return [(np.asarray(image, np.uint8), False)]
    from dct_tpu.models import color as _color

    y, cb, cr = _color._to_planes(jnp.asarray(image, jnp.uint8), cfg.chroma)
    return [
        (np.asarray(y), False), (np.asarray(cb), True), (np.asarray(cr), True),
    ]


def _container_size_from_planes(
    plane_args: list[tuple[np.ndarray, bool]],
    cfg: CodecConfig,
    w: int,
    h: int,
    mesh=None,
) -> int:
    payload = 0
    skeletons = []
    for plane, chroma in plane_args:
        bits, skel = _plane_size(plane, cfg, chroma, mesh=mesh)
        payload += int(((bits.astype(np.int64) + 7) // 8).sum())
        skeletons.append(skel)
    header = len(
        cont.serialize(
            cont.Container(config=cfg, width=w, height=h, planes=skeletons)
        )
    )
    return header + payload


def container_size(image: np.ndarray, cfg: CodecConfig, mesh=None) -> int:
    """EXACT serialized container size in bytes for encoding `image` under
    `cfg` — without packing or materializing the payload.

    Grayscale (H, W) or RGB (H, W, 3) by array rank, with codec.encode's
    chroma normalization (RGB + chroma='gray' switches to '420'). With a
    jax.sharding.Mesh the probe runs stripe-sharded
    (parallel/shard_encode.plane_probe_bits_sharded) and returns the same
    integer for every mesh shape."""
    cfg = _normalize_chroma(image.ndim, cfg)
    return _container_size_from_planes(
        _image_plane_args(image, cfg), cfg,
        int(image.shape[1]), int(image.shape[0]), mesh=mesh,
    )


# ---------------------------------------------------------------------------
# Video (batched frame stacks, models/video.py)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "n_stripes"))
def _chunk_bits_batch(
    symbols, cfg, n_stripes, lengths, codes, run_lengths=None, run_codes=None
):
    """Per-frame (stripe bits (F, S), block bits (F, NB))."""
    return jax.vmap(
        lambda s: _chunk_bits(
            s, cfg, n_stripes, lengths, codes, run_lengths, run_codes
        )
    )(symbols)


def _plane_batch_bits(
    planes: np.ndarray,
    cfg: CodecConfig,
    chroma: bool,
    chunk_frames: int | None,
):
    """((F, n_stripes) per-stripe bit counts, (F, NB) per-block bit
    counts, skeleton factory frame_idx -> PlaneData) for a frame-stack
    plane batch at cfg.quality. Mirrors video._encode_plane_batch
    (batch-GLOBAL dynamic tables, chunked dispatches) up to but not
    including the pack, so the counts equal the packer's bit_lengths for
    every frame. Skeletons are PER FRAME: the packed decode index's
    width (and serialize()'s "auto" decision) depends on each frame's
    own block bit counts, so frame container sizes can differ even with
    shared tables.

    Like the encoder's pass 1, symbols are DROPPED per chunk when the
    stack spans multiple chunks (retaining them would unbound the device
    memory CHUNK_PIXEL_BUDGET exists to bound) and pass 2 re-analyzes;
    a single-chunk stack analyzes once."""
    from dct_tpu.models import video as _video

    f, h, w = (int(x) for x in planes.shape)
    bh, bw, n_stripes = _codec._padded_grid(h, w, cfg)
    n = cfg.block_size
    ph, pw = bh * n, bw * n
    if chunk_frames is None:
        chunk_frames = max(1, _video.CHUNK_PIXEL_BUDGET // (h * w))
    chunk = max(1, min(int(chunk_frames), f))

    def prep(sub):
        imgs = blk.pad_to_blocks(jnp.asarray(sub, jnp.uint8), n)
        return jnp.pad(
            imgs,
            ((0, 0), (0, ph - imgs.shape[1]), (0, pw - imgs.shape[2])),
            mode="edge",
        )

    symbols_once = None
    if cfg.static_tables:
        table = _codec._build_table(cfg, None)
        run_table = _codec._build_run_table(cfg, None)
    elif f <= chunk:
        symbols_once, _, hist, run_hist = _video._analyze_batch(
            prep(planes), cfg, chroma=chroma
        )
        table = _codec._build_table(cfg, np.asarray(hist))
        run_table = _codec._build_run_table(cfg, np.asarray(run_hist))
    else:
        hist = run_hist = None
        for i0 in range(0, f, chunk):
            _, _, h_, rh_ = _video._analyze_batch(
                prep(planes[i0 : i0 + chunk]), cfg, chroma=chroma
            )
            hist = np.asarray(h_, np.int64) + (0 if hist is None else hist)
            run_hist = (
                np.asarray(rh_, np.int64)
                + (0 if run_hist is None else run_hist)
            )
        table = _codec._build_table(cfg, hist)
        run_table = _codec._build_run_table(cfg, run_hist)
    lengths, codes = _codec._table_arrays(table)
    if cfg.coded_runs:
        run_lengths, run_codes = _codec._table_arrays(run_table)
    else:
        run_lengths = run_codes = None

    bits = []
    bbs = []
    for i0 in range(0, f, chunk):
        if symbols_once is not None:
            sym = symbols_once
        else:
            sym, _, _, _ = _video._analyze_batch(
                prep(planes[i0 : i0 + chunk]), cfg, chroma=chroma
            )
        b, bb = _chunk_bits_batch(
            sym, cfg, n_stripes, lengths, codes, run_lengths, run_codes
        )
        bits.append(np.asarray(b))
        bbs.append(np.asarray(bb))
    bits = np.concatenate(bits, axis=0)
    bbs = np.concatenate(bbs, axis=0)

    def skeleton(i: int) -> cont.PlaneData:
        return _probe_skeleton(
            w, h, cfg, n_stripes, table, run_table,
            np.zeros(bh * bw, np.uint8) if cfg.adaptive else None,
            bits[i], bbs[i],
        )

    return bits, bbs, skeleton


def _video_plane_batches(
    frames: np.ndarray, cfg: CodecConfig, chunk_frames: int | None
) -> list[tuple[np.ndarray, bool]]:
    """Frame stack -> [(plane batch, is_chroma)], with the RGB->YCbCr
    conversion CHUNKED exactly like VideoCodec.encode (the f32
    intermediates of a whole long stack would dwarf the u8 planes they
    produce — video.py). Quality-independent, so encode_video_to_size
    hoists this out of the per-rung probe loop."""
    if cfg.chroma == "gray":
        if frames.ndim != 3:
            raise ValueError(f"expected (F, H, W), got {frames.shape}")
        return [(np.asarray(frames, np.uint8), False)]
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(
            f"expected (F, H, W, 3) RGB for chroma={cfg.chroma}, "
            f"got {frames.shape}"
        )
    from dct_tpu.models import color as _color
    from dct_tpu.models import video as _video

    f, h, w = (int(x) for x in frames.shape[:3])
    cc = chunk_frames or max(1, _video.CHUNK_PIXEL_BUDGET // (h * w))
    parts = [[], [], []]
    for i0 in range(0, f, cc):
        planes = jax.vmap(lambda im: _color._to_planes(im, cfg.chroma))(
            jnp.asarray(frames[i0 : i0 + cc], jnp.uint8)
        )
        for lst, p in zip(parts, planes):
            lst.append(np.asarray(p))
    y, cb, cr = (np.concatenate(lst) for lst in parts)
    return [(y, False), (cb, True), (cr, True)]


def _video_sizes_from_batches(
    plane_batches: list[tuple[np.ndarray, bool]],
    cfg: CodecConfig,
    w: int,
    h: int,
    chunk_frames: int | None,
    mesh=None,
) -> np.ndarray:
    f = int(plane_batches[0][0].shape[0])
    per_frame = np.zeros(f, np.int64)
    skel_factories = []
    for batch, chroma in plane_batches:
        if mesh is not None:
            from dct_tpu.parallel import shard_encode as _se

            bits, bbs, table, run_table = (
                _se.video_plane_batch_bits_sharded(
                    batch, cfg, mesh, chroma, chunk_frames
                )
            )
            bh, bw, n_stripes = _codec._padded_grid(
                int(batch.shape[1]), int(batch.shape[2]), cfg
            )

            def skel(i, bits=bits, bbs=bbs, table=table,
                     run_table=run_table, batch=batch, bh=bh, bw=bw,
                     n_stripes=n_stripes):
                return _probe_skeleton(
                    int(batch.shape[2]), int(batch.shape[1]), cfg,
                    n_stripes, table, run_table,
                    np.zeros(bh * bw, np.uint8) if cfg.adaptive else None,
                    bits[i], bbs[i],
                )
        else:
            bits, bbs, skel = _plane_batch_bits(
                batch, cfg, chroma, chunk_frames
            )
        per_frame += ((bits.astype(np.int64) + 7) // 8).sum(axis=1)
        skel_factories.append(skel)
    # headers are PER FRAME: the packed decode index's width (and the
    # "auto" include decision) vary with each frame's block bit counts
    for i in range(f):
        per_frame[i] += len(cont.serialize(cont.Container(
            config=cfg, width=w, height=h,
            planes=[sk(i) for sk in skel_factories],
        )))
    return per_frame


def video_container_sizes(
    frames: np.ndarray,
    cfg: CodecConfig,
    chunk_frames: int | None = None,
    mesh=None,
) -> np.ndarray:
    """EXACT per-frame container sizes (bytes) for VideoCodec(cfg).encode
    (frames), without packing: (F,) int64. Remember that the batch shares
    ONE table per plane type, so these differ from per-image
    container_size whenever tables are dynamic. With a mesh the probe
    runs dp x sp sharded and returns the same integers for every mesh
    shape."""
    batches = _video_plane_batches(frames, cfg, chunk_frames)
    h, w = int(frames.shape[1]), int(frames.shape[2])
    return _video_sizes_from_batches(batches, cfg, w, h, chunk_frames,
                                     mesh=mesh)


def encode_video_to_size(
    frames: np.ndarray,
    total_bytes: int,
    config: CodecConfig | None = None,
    qualities: tuple[int, ...] = DEFAULT_LADDER,
    strict: bool = True,
    chunk_frames: int | None = None,
    mesh=None,
) -> tuple[list[bytes], int]:
    """Encode a frame stack into at most `total_bytes` across all per-frame
    containers, at one shared quality (the batch analog of encode_to_size;
    per-frame streams stay individually decodable). Returns
    (streams, quality). With a jax.sharding.Mesh, probes AND the final
    encode run dp x sp sharded; chosen quality and bytes are mesh-shape-
    invariant."""
    base = config or CodecConfig()
    if frames.ndim == 4 and base.chroma == "gray":
        base = base.replace(chroma="420")
    ladder = _clean_ladder(qualities)
    # the RGB->YCbCr split is quality-independent: convert once, not per rung
    batches = _video_plane_batches(frames, base, chunk_frames)
    h, w = int(frames.shape[1]), int(frames.shape[2])

    totals: dict[int, int] = {}

    def size_of(q: int) -> int:
        if q not in totals:
            totals[q] = int(_video_sizes_from_batches(
                batches, base.replace(quality=q), w, h, chunk_frames,
                mesh=mesh,
            ).sum())
        return totals[q]

    best = _ladder_bisect(
        ladder,
        lambda q: size_of(q) <= total_bytes,
        strict,
        lambda q: (
            f"quality {q} needs {size_of(q)} bytes > budget {total_bytes}"
        ),
    )
    from dct_tpu.models.video import VideoCodec

    streams = VideoCodec(
        base.replace(quality=best), chunk_frames=chunk_frames, mesh=mesh
    ).encode(frames)
    return streams, best


# ---------------------------------------------------------------------------
# Distortion probes (exact PSNR without a bitstream)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "chroma", "h", "w"))
def _plane_sse_chunks(
    plane_padded: jax.Array, cfg: CodecConfig, chroma: bool, h: int, w: int
) -> jax.Array:
    """Exact roundtrip squared error of one padded plane vs its unpadded
    region, as (h, ceil(w/4096)) int32 column-chunk partial sums.

    Runs the production transform pair via _plane_roundtrip (the same ops
    decode_plane_device uses), so the reconstruction is bit-identical to
    decoding a real container (the wire carries these exact integers).
    Chunked int32 keeps the sum exact
    without x64: each chunk is at most 4096 * 255^2 < 2^31; the caller
    totals chunks in Python ints."""
    img = _plane_roundtrip(plane_padded, cfg, chroma)[:h, :w]
    d = img.astype(jnp.int32) - plane_padded[:h, :w].astype(jnp.int32)
    sq = d * d
    pad_w = -(-w // 4096) * 4096
    if pad_w != w:
        sq = jnp.pad(sq, ((0, 0), (0, pad_w - w)))
    return sq.reshape(h, pad_w // 4096, 4096).sum(axis=2)


def roundtrip_sse(image: np.ndarray, cfg: CodecConfig, mesh=None) -> int:
    """EXACT sum of squared pixel errors of encode->decode under `cfg`,
    without producing a bitstream. Grayscale (H, W) only; color goes
    through psnr_at_quality (the RGB reconstruction crosses planes).
    With a mesh the roundtrip runs stripe-sharded
    (parallel/shard_encode.plane_sse_chunks_sharded) — same integer for
    every mesh shape (pad rows are masked, and integer chunk sums are
    order-exact)."""
    if image.ndim != 2:
        raise ValueError("roundtrip_sse takes a grayscale (H, W) plane")
    h, w = int(image.shape[0]), int(image.shape[1])
    if mesh is not None:
        from dct_tpu.parallel import shard_encode as _se

        chunks = np.asarray(
            _se.plane_sse_chunks_sharded(image, cfg, mesh, False, h, w)
        )
    else:
        chunks = np.asarray(
            _plane_sse_chunks(_pad_plane(image, cfg), cfg, False, h, w)
        )
    return int(sum(int(x) for x in chunks.ravel()))


@functools.partial(jax.jit, static_argnames=("cfg", "h", "w"))
def _rgb_sse_chunks(
    rgb: jax.Array, cfg: CodecConfig, h: int, w: int
) -> jax.Array:
    """Exact roundtrip squared error for an RGB image: the full color
    pipeline (YCbCr split, per-plane quantize/reconstruct with the chroma
    table and 4:2:0 resampling, RGB reassembly) mirroring
    ColorImageCodec.decode_to_device, reduced to int32 column chunks."""
    from dct_tpu.models import color as _color

    planes = _color._to_planes(rgb, cfg.chroma)
    recs = []
    for i, plane in enumerate(planes):
        ph_, pw_ = int(plane.shape[0]), int(plane.shape[1])
        rec = _plane_roundtrip(_pad_plane(plane, cfg), cfg, chroma=i > 0)
        recs.append(rec[:ph_, :pw_])
    out = _color.planes_to_rgb(recs[0], recs[1], recs[2], cfg.chroma, h, w)
    d = out.astype(jnp.int32) - rgb.astype(jnp.int32)
    sq = (d * d).sum(axis=2)  # <= 3 * 255^2 per pixel
    pad_w = -(-w // 1024) * 1024
    if pad_w != w:
        sq = jnp.pad(sq, ((0, 0), (0, pad_w - w)))
    return sq.reshape(h, pad_w // 1024, 1024).sum(axis=2)


def _rgb_sse_sharded(image: np.ndarray, cfg: CodecConfig, mesh) -> int:
    """Sharded RGB distortion probe: per-plane roundtrips run stripe-
    sharded (shard_map, each device on its own stripe rows), then the cross-plane YCbCr recombine + squared diff run
    under plain jit over the row-sharded planes (elementwise + upsample;
    XLA inserts the resharding). Integer chunk sums are order-exact, so
    the total equals _rgb_sse_chunks' for every mesh shape."""
    from dct_tpu.models import color as _color
    from dct_tpu.parallel import shard_encode as _se

    h, w = int(image.shape[0]), int(image.shape[1])
    planes = _color._to_planes(jnp.asarray(image, jnp.uint8), cfg.chroma)
    recs = []
    for i, plane in enumerate(planes):
        ph_, pw_ = int(plane.shape[0]), int(plane.shape[1])
        rec = _se.plane_roundtrip_sharded(
            np.asarray(plane), cfg, mesh, chroma=i > 0
        )
        recs.append(rec[:ph_, :pw_])

    @functools.partial(jax.jit, static_argnames=("chroma",))
    def sse_chunks(y, cb, cr, rgb, chroma):
        out = _color.planes_to_rgb(y, cb, cr, chroma, h, w)
        d = out.astype(jnp.int32) - rgb.astype(jnp.int32)
        sq = (d * d).sum(axis=2)  # <= 3 * 255^2 per pixel
        pad_w = -(-w // 1024) * 1024
        if pad_w != w:
            sq = jnp.pad(sq, ((0, 0), (0, pad_w - w)))
        return sq.reshape(h, pad_w // 1024, 1024).sum(axis=2)

    chunks = np.asarray(sse_chunks(
        recs[0], recs[1], recs[2], jnp.asarray(image, jnp.uint8), cfg.chroma
    ))
    return int(sum(int(x) for x in chunks.ravel()))


def psnr_at_quality(image: np.ndarray, cfg: CodecConfig, mesh=None) -> float:
    """EXACT PSNR (dB) of encoding `image` under `cfg` — float-identical
    to metrics.psnr(image, decode(encode(image, cfg))) — without packing
    or parsing a bitstream. Probes run entirely on device; only int32
    partial sums are fetched. With a mesh the roundtrips run stripe-
    sharded; the result is float-identical for every mesh shape.

    Float-identical because both compute 10*log10(255^2 / (sse / n)) in
    float64 and metrics.mse's np.mean over integer-valued f64 squares is
    exact below 2^53 (any image under ~10^8 pixels)."""
    cfg = _normalize_chroma(image.ndim, cfg)
    h, w = int(image.shape[0]), int(image.shape[1])
    if image.ndim == 2:
        sse = roundtrip_sse(image, cfg, mesh=mesh)
        n_px = h * w
    elif mesh is not None:
        sse = _rgb_sse_sharded(image, cfg, mesh)
        n_px = h * w * 3
    else:
        chunks = np.asarray(
            _rgb_sse_chunks(jnp.asarray(image, jnp.uint8), cfg, h, w)
        )
        sse = int(sum(int(x) for x in chunks.ravel()))
        n_px = h * w * 3
    if sse == 0:
        return float("inf")
    mse = sse / n_px  # metrics.mse computes exactly this value in f64
    return float(10.0 * np.log10(255.0**2 / mse))


def encode_to_psnr(
    image: np.ndarray,
    min_psnr: float,
    config: CodecConfig | None = None,
    qualities: tuple[int, ...] = DEFAULT_LADDER,
    strict: bool = True,
    mesh=None,
) -> tuple[bytes, int]:
    """Encode `image` at the LOWEST ladder quality whose exact PSNR meets
    `min_psnr` dB (smallest file achieving the distortion target — the
    quality-targeted dual of encode_to_size). Returns (bytes, quality).

    If even the highest rung misses the target: raise ValueError when
    `strict`, else return the highest-rung encode (best effort). With a
    jax.sharding.Mesh, probes and the final encode run stripe-sharded;
    the chosen quality and bytes are mesh-shape-invariant."""
    base = _normalize_chroma(image.ndim, config or CodecConfig())
    ladder = _clean_ladder(qualities)[::-1]  # descending: see _ladder_bisect

    psnrs: dict[int, float] = {}

    def psnr_of(q: int) -> float:
        if q not in psnrs:
            psnrs[q] = psnr_at_quality(
                image, base.replace(quality=q), mesh=mesh
            )
        return psnrs[q]

    best = _ladder_bisect(
        ladder,
        lambda q: psnr_of(q) >= min_psnr,
        strict,
        lambda q: (
            f"quality {q} reaches only {psnr_of(q):.2f} dB < "
            f"target {min_psnr}"
        ),
    )
    if mesh is not None:
        from dct_tpu.parallel import shard_encode as _se

        return _se.encode_image_sharded(
            np.asarray(image), base.replace(quality=best), mesh
        ), best
    data = _codec.encode(image, base.replace(quality=best))
    return data, best


def encode_to_size(
    image: np.ndarray,
    max_bytes: int,
    config: CodecConfig | None = None,
    qualities: tuple[int, ...] = DEFAULT_LADDER,
    strict: bool = True,
    mesh=None,
) -> tuple[bytes, int]:
    """Encode `image` into at most `max_bytes`, choosing the highest
    quality on the ladder that fits. Returns (container bytes, quality).

    `config` supplies every knob except quality (its quality field is
    ignored). If even the lowest rung exceeds the budget: raise ValueError
    when `strict`, else return the lowest-rung encode (over budget, best
    effort). Probes are exact (see container_size), so the returned
    container always fits when a fitting rung exists.

    With a jax.sharding.Mesh, both the probes AND the final encode run
    stripe-sharded (parallel/shard_encode) — the chosen quality and the
    returned bytes are identical for every mesh shape (and to the
    unsharded call), because probes ride the same psum-globalized tables
    and masked chunk sums the sharded encoder uses."""
    base = _normalize_chroma(image.ndim, config or CodecConfig())
    ladder = _clean_ladder(qualities)
    # the RGB->YCbCr split is quality-independent: convert once, not per rung
    plane_args = _image_plane_args(image, base)
    w, h = int(image.shape[1]), int(image.shape[0])

    sizes: dict[int, int] = {}

    def size_of(q: int) -> int:
        if q not in sizes:
            sizes[q] = _container_size_from_planes(
                plane_args, base.replace(quality=q), w, h, mesh=mesh
            )
        return sizes[q]

    best = _ladder_bisect(
        ladder,
        lambda q: size_of(q) <= max_bytes,
        strict,
        lambda q: f"quality {q} needs {size_of(q)} bytes > budget {max_bytes}",
    )
    if mesh is not None:
        from dct_tpu.parallel import shard_encode as _se

        return _se.encode_image_sharded(
            np.asarray(image), base.replace(quality=best), mesh
        ), best
    data = _codec.encode(image, base.replace(quality=best))
    return data, best
