"""End-to-end grayscale image codec: u8 image -> TPDC bitstream -> u8 image.

This is the driver the reference never wrote (its image-level loop exists
only as the orphaned create_block_from_pixels helper, dct.c:109-120 /
SURVEY.md section 3.5). Pipeline per plane:

  encode:  tile -> [device] fused DCT+quant matmul -> RLE scans ->
           category histogram -> [host] canonical table (16 ints) ->
           [device] chunk/offset scans + scatter bit-pack ->
           [host] stripe bytes + container

  decode:  [host] parse container + Huffman-decode stripes to zigzag
           coefficients (the native C++ decoder when built, else Python) ->
           [device] fused dequant+IDCT matmul -> crop
  decode_to_device of an indexed (v2) container: [device] entropy decode
           of every block at once (ops/entropy_decode.py) -> dequant+IDCT

Two device dispatches per image with a 64-byte histogram sync between them
— the irreducible structure of any two-pass entropy coder with per-image
tables. Static-table mode (cfg.static_tables) collapses encode to one
dispatch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dct_tpu import container as cont
from dct_tpu.config import CodecConfig
from dct_tpu.ops import bitstream as bs
from dct_tpu.ops import blocks as blk
from dct_tpu.ops import entropy_decode as ed
from dct_tpu.ops import huffman as hf
from dct_tpu.ops import quant, rle, transform

DIRECT_VMIN = -255  # direct-mode alphabet [-255, 255] + ESC (reference values
# beyond 8-bit magnitude are rare; they escape to raw 16-bit)
DIRECT_ALPHABET = 511


def _padded_grid(h: int, w: int, cfg: CodecConfig) -> tuple[int, int, int]:
    """(block rows padded to stripe multiple, block cols, n_stripes)."""
    n = cfg.block_size
    bh = -(-h // n)
    bw = -(-w // n)
    bh = -(-bh // cfg.stripe_rows) * cfg.stripe_rows
    return bh, bw, bh // cfg.stripe_rows


def dc_predict(zz: jax.Array, n_stripes: int) -> jax.Array:
    """Stripe-local DC DPCM (cfg.dc_prediction): each block's DC becomes
    the delta against the previous block in its stripe (first block raw).
    Integer-domain, exactly invertible by dc_reconstruct; stripe-local so
    per-stripe independence (recovery, sharded encode) is preserved."""
    nb = zz.shape[0]
    dc = zz[:, 0].reshape(n_stripes, nb // n_stripes)
    prev = jnp.pad(dc[:, :-1], ((0, 0), (1, 0)))
    return zz.at[:, 0].set((dc - prev).reshape(-1))


def dc_reconstruct(zz, n_stripes: int):
    """Inverse of dc_predict (works on jax or numpy arrays)."""
    nb = zz.shape[0]
    dc = zz[:, 0].reshape(n_stripes, nb // n_stripes)
    if isinstance(zz, np.ndarray):
        out = zz.copy()
        out[:, 0] = np.cumsum(dc, axis=1).reshape(-1)
        return out
    return zz.at[:, 0].set(jnp.cumsum(dc, axis=1).reshape(-1))


@functools.partial(jax.jit, static_argnames=("cfg", "chroma"))
def encode_analyze(image: jax.Array, cfg: CodecConfig, chroma: bool = False):
    """Stage 1 on device: padded plane -> (symbols, var_codes, histogram,
    run_histogram).

    image: (Hp, Wp) u8, already padded to the stripe grid. run_histogram is
    a (64,) run-length histogram when cfg.coded_runs, else a zero stub.
    """
    n = cfg.block_size
    pixels = blk.image_to_blocks(image, n)  # (NB, n^2)
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
        n_stripes = (image.shape[0] // n) // cfg.stripe_rows
        zz = dc_predict(zz, n_stripes)
    if cfg.use_huffman and cfg.huffman_mode == "direct":
        # direct mode histograms over a 512-bin alphabet (511 values +
        # ESC); compacted form
        symbols = rle.rle_encode(zz)
        hist = hf.value_histogram(
            symbols.values, symbols.counts, DIRECT_VMIN, -DIRECT_VMIN
        )
        s_idx = jnp.arange(symbols.values.shape[1])[None, :]
        live = s_idx < symbols.counts[:, None]
    else:
        # hot path: positional symbols, no compaction sort
        symbols = rle.rle_encode_positional(zz)
        live = symbols.is_sym
        if cfg.use_huffman and cfg.huffman_mode == "category":
            hist = hf.category_histogram_masked(symbols.values, symbols.is_sym)
        else:
            hist = jnp.zeros(1, jnp.int32)
    if cfg.coded_runs:
        run_hist = hf.run_histogram_masked(symbols.runs, live)
    else:
        run_hist = jnp.zeros(1, jnp.int32)
    return symbols, var_codes, hist, run_hist


def symbol_chunks_for(
    symbols,
    cfg: CodecConfig,
    lengths: jax.Array,
    codes: jax.Array,
    run_lengths: jax.Array | None = None,
    run_codes: jax.Array | None = None,
):
    """The codec's single mode-dispatch over bs.symbol_chunks: (cv, cl).

    Shared by the packer (encode_pack) and the rate-control size probes
    (models/rate_control.py) — the probes' byte-exactness contract is
    that they reduce the SAME chunk-length tensor the packer offsets by,
    which this shared dispatch makes structural."""
    rkw = dict(
        run_lengths=run_lengths,
        run_codes=run_codes,
        run_bits=bs.run_field_bits(cfg.n2),
    )
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    if mode == "category":
        return bs.symbol_chunks(
            symbols, mode, cat_lengths=lengths, cat_codes=codes, **rkw
        )
    if mode == "direct":
        return bs.symbol_chunks(
            symbols, mode, val_lengths=lengths, val_codes=codes,
            vmin=DIRECT_VMIN, **rkw
        )
    return bs.symbol_chunks(symbols, mode, **rkw)


@functools.partial(
    jax.jit, static_argnames=("cfg", "n_stripes", "return_block_bits")
)
def encode_pack(
    symbols: rle.RLEBlocks,
    cfg: CodecConfig,
    n_stripes: int,
    lengths: jax.Array,
    codes: jax.Array,
    run_lengths: jax.Array | None = None,
    run_codes: jax.Array | None = None,
    return_block_bits: bool = False,
):
    """Stage 2 on device: symbols + canonical table -> packed stripe units.

    return_block_bits: also return (n_stripes, bps) per-block bit lengths
    (cfg.decode_index) — the chunk-length sums per block."""
    if cfg.coded_runs and run_lengths is None:
        raise ValueError("coded_runs requires a run table")
    cv, cl = symbol_chunks_for(
        symbols, cfg, lengths, codes, run_lengths, run_codes
    )
    nb = symbols.values.shape[0]
    bps = nb // n_stripes  # blocks per stripe (static)
    block_bits = jnp.sum(cl, axis=(1, 2)).reshape(n_stripes, bps)
    cv = cv.reshape(n_stripes, bps * cv.shape[1], 3)
    cl = cl.reshape(n_stripes, bps * cl.shape[1], 3)
    capacity = bps * bs.units_per_block_worst(cfg.n2, cfg.coded_runs)
    packed = bs.pack_chunks(cv, cl, capacity)
    return (packed, block_bits) if return_block_bits else packed


def _build_table(cfg: CodecConfig, hist: np.ndarray) -> hf.CanonicalTable | None:
    if not cfg.use_huffman or cfg.huffman_mode == "none":
        return None
    if cfg.static_tables:
        if cfg.huffman_mode != "category":
            raise ValueError("static_tables requires huffman_mode='category'")
        return hf.default_category_table(cfg.quality)
    return hf.CanonicalTable.from_frequencies(hist)


def _build_run_table(
    cfg: CodecConfig, run_hist: np.ndarray | None
) -> hf.CanonicalTable | None:
    if not cfg.coded_runs:
        return None
    if cfg.static_tables or run_hist is None:
        return hf.default_run_table(cfg.quality)
    # +1 smoothing: every run 0..64 must stay encodable even if absent
    # from this image (repair re-encodes stripes against the stored table)
    return hf.CanonicalTable.from_frequencies(
        np.asarray(run_hist, np.int64) + 1, max_len=hf.RUN_MAX_CODE_LEN
    )


def _table_arrays(t: hf.CanonicalTable | None):
    if t is None:
        return jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.uint32)
    return (
        jnp.asarray(t.lengths, jnp.int32),
        jnp.asarray(t.codes.astype(np.int64), jnp.uint32),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "n_stripes", "chroma"))
def encode_step(
    image: jax.Array, cfg: CodecConfig, n_stripes: int, chroma: bool = False
):
    """Single-dispatch full encode (static-table mode): padded plane ->
    (PackedStripes, var_codes, block_bits) — block_bits is the
    (n_stripes, bps) per-block bit lengths when cfg.decode_index is
    truthy (True or the default "auto"), else None; var_codes is None
    unless cfg.adaptive. Fully jittable end to end — no host sync — hence
    directly shardable over a device mesh (parallel/shard_encode.py) and
    the unit __graft_entry__.entry() and dryrun_multichip exercise.
    """
    if not cfg.static_tables:
        raise ValueError("encode_step requires cfg.static_tables")
    table = hf.default_category_table(cfg.quality)
    lengths, codes = _table_arrays(table)
    if cfg.coded_runs:
        run_lengths, run_codes = _table_arrays(_build_run_table(cfg, None))
    else:
        run_lengths = run_codes = None
    n = cfg.block_size
    pixels = blk.image_to_blocks(image, n)
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
        zz = dc_predict(zz, n_stripes)
    symbols = rle.rle_encode_positional(zz)
    out = encode_pack(
        symbols, cfg, n_stripes, lengths, codes, run_lengths, run_codes,
        return_block_bits=bool(cfg.decode_index),
    )
    if cfg.decode_index:
        packed, block_bits = out
        return packed, var_codes, block_bits
    return out, var_codes, None


def pad_plane_for_encode(plane, cfg: CodecConfig) -> jax.Array:
    """The canonical encoder padding: block grid (edge-replicated) then
    stripe grid. ONE implementation shared by encode_plane and the
    rate-control probes (models/rate_control.py) so a padding change can
    never silently break the probes' byte-exactness contract. Accepts
    host arrays or traced values (shapes are static under jit)."""
    h, w = int(plane.shape[0]), int(plane.shape[1])
    bh, bw, _ = _padded_grid(h, w, cfg)
    n = cfg.block_size
    img = blk.pad_to_blocks(jnp.asarray(plane, jnp.uint8), n)
    ph, pw = bh * n, bw * n
    if img.shape[0] != ph or img.shape[1] != pw:
        img = jnp.pad(
            img, ((0, ph - img.shape[0]), (0, pw - img.shape[1])), mode="edge"
        )
    return img


def encode_plane(
    plane: np.ndarray, cfg: CodecConfig, chroma: bool = False
) -> cont.PlaneData:
    """Encode one u8 plane to PlaneData (device compute + host assembly)."""
    h, w = int(plane.shape[0]), int(plane.shape[1])
    _, _, n_stripes = _padded_grid(h, w, cfg)
    img = pad_plane_for_encode(plane, cfg)

    block_bits = None
    if cfg.static_tables:
        table = _build_table(cfg, None)
        run_table = _build_run_table(cfg, None)
        packed, var_codes, block_bits = encode_step(
            img, cfg, n_stripes, chroma=chroma
        )
    else:
        symbols, var_codes, hist, run_hist = encode_analyze(
            img, cfg, chroma=chroma
        )
        table = _build_table(cfg, np.asarray(hist))
        run_table = _build_run_table(cfg, np.asarray(run_hist))
        lengths, codes = _table_arrays(table)
        if cfg.coded_runs:
            run_lengths, run_codes = _table_arrays(run_table)
        else:
            run_lengths = run_codes = None
        res = encode_pack(
            symbols, cfg, n_stripes, lengths, codes, run_lengths,
            run_codes, return_block_bits=bool(cfg.decode_index),
        )
        if cfg.decode_index:
            packed, block_bits = res
        else:
            packed = res
    packed = bs.fetch_packed(packed)  # trim worst-case slack before D2H
    stripes = bs.stripes_to_bytes(packed)
    return cont.PlaneData(
        width=w,
        height=h,
        table_lengths=table.lengths if table is not None else None,
        vmin=DIRECT_VMIN,
        variance_codes=np.asarray(var_codes) if cfg.adaptive else None,
        stripe_bits=packed.bit_lengths.astype(np.uint32),
        stripes=stripes,
        run_table_lengths=(
            run_table.lengths if run_table is not None else None
        ),
        block_bits=(
            np.asarray(block_bits).reshape(-1).astype(np.uint16)
            if block_bits is not None else None
        ),
    )


def _device_decode_prep(
    planes: list[cont.PlaneData], table, mode: str, run_table=None
):
    """Host prep for the device entropy decode of one or more indexed
    planes that share tables: (stripe words, (stripes, bps) block bits,
    table operands), the planes' stripes stacked in order. None when a
    plane has no decode index or the tables need the host decoder
    (ops/entropy_decode.tables_supported)."""
    if any(p.block_bits is None for p in planes) or not ed.tables_supported(
        table, run_table, DIRECT_VMIN
    ):
        return None
    block_bits = np.concatenate([
        np.asarray(p.block_bits, np.int32).reshape(len(p.stripes), -1)
        for p in planes
    ])
    return (
        ed.stripe_words([s for p in planes for s in p.stripes]),
        block_bits,
        *ed.table_operands(table, run_table, mode, DIRECT_VMIN),
    )


def _entropy_statics(cfg: CodecConfig) -> dict:
    """Static arguments of ed.decode_blocks for this config."""
    return dict(
        n2=cfg.n2,
        mode=cfg.huffman_mode if cfg.use_huffman else "none",
        coded_runs=cfg.coded_runs,
        run_bits=bs.run_field_bits(cfg.n2),
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "chroma", "n_stripes", "bh", "bw")
)
def _reconstruct(zz, var_codes, cfg, chroma, n_stripes, bh, bw):
    """(NB, n2) coefficients -> (bh*n, bw*n) u8 plane on device: DC
    un-prediction, dequant+IDCT, image assembly."""
    zz = zz.astype(jnp.int32)
    if cfg.dc_prediction:
        zz = dc_reconstruct(zz, n_stripes)
    scale = None
    if cfg.adaptive:
        scale = quant.scale_from_variance_code(var_codes)
    pixels = transform.decode_blocks(
        zz, cfg, adaptive_scale=scale, chroma=chroma
    )
    n = cfg.block_size
    return blk.blocks_to_image(pixels, bh * n, bw * n, n)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "chroma", "bh", "bw", "height", "width"),
)
def _device_decode_step(
    arrays, var_codes, cfg: CodecConfig, chroma: bool, bh: int, bw: int,
    height: int, width: int,
):
    """The whole indexed decode of one plane, or of F planes stacked along
    the stripe axis, as one jitted step: device entropy decode -> DC
    un-prediction -> dequant+IDCT -> image assembly -> crop. Returns
    (F, height, width) u8, F = var_codes.shape[0] (see _var_codes).
    Pixels never leave the device."""
    n_stripes = bh // cfg.stripe_rows
    zz = ed.decode_blocks(*arrays, **_entropy_statics(cfg))
    zz = zz.reshape(var_codes.shape[0], bh * bw, cfg.n2)
    imgs = jax.vmap(
        lambda z, vc: _reconstruct(z, vc, cfg, chroma, n_stripes, bh, bw)
    )(zz, var_codes)
    return imgs[:, :height, :width]


def _plane_tables(p: cont.PlaneData, cfg: CodecConfig):
    """(mode, table, run_table) of a container plane."""
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    table = hf.CanonicalTable(p.table_lengths) if mode != "none" else None
    run_table = (
        hf.CanonicalTable(p.run_table_lengths) if cfg.coded_runs else None
    )
    return mode, table, run_table


def _var_codes(planes: list[cont.PlaneData], cfg: CodecConfig) -> np.ndarray:
    """(F, NB) variance codes of the planes, or (F, 1) zeros when not
    adaptive."""
    if cfg.adaptive:
        return np.stack([np.asarray(p.variance_codes, np.uint8) for p in planes])
    return np.zeros((len(planes), 1), np.uint8)


def _decode_plane_host_entropy(
    p: cont.PlaneData, cfg: CodecConfig, chroma: bool = False
) -> jax.Array:
    """Host entropy decode (native C++ or Python) -> int16 coefficient
    upload -> device dequant+IDCT; the reconstruction stays on device."""
    bh, bw, n_stripes = _padded_grid(p.height, p.width, cfg)
    bps = (bh // n_stripes) * bw  # blocks per stripe
    mode, table, run_table = _plane_tables(p, cfg)
    zz = _decode_stripes(p, cfg, table, mode, n_stripes, bps, run_table)
    vc = jnp.asarray(p.variance_codes) if cfg.adaptive else None
    img = _reconstruct(jnp.asarray(zz), vc, cfg, chroma, n_stripes, bh, bw)
    return img[: p.height, : p.width]


def decode_plane_device(
    p: cont.PlaneData, cfg: CodecConfig, chroma: bool = False
) -> jax.Array:
    """PlaneData -> reconstructed u8 plane as a DEVICE array.

    The path for consumers whose next stage is on the device (e.g.
    decoded frames feeding a model). With a decode index in the container
    (container v2) the entropy stage runs ON DEVICE (ops/entropy_decode.py)
    and only the packed stripe bytes cross to the device; otherwise the
    host entropy decode feeds the dequant+IDCT on device. Either way the
    pixels stay on the device."""
    mode, table, run_table = _plane_tables(p, cfg)
    arrays = _device_decode_prep([p], table, mode, run_table)
    if arrays is None:
        return _decode_plane_host_entropy(p, cfg, chroma)
    bh, bw, _ = _padded_grid(p.height, p.width, cfg)
    return _device_decode_step(
        arrays, _var_codes([p], cfg), cfg=cfg, chroma=chroma, bh=bh, bw=bw,
        height=p.height, width=p.width,
    )[0]


def decode_plane(p: cont.PlaneData, cfg: CodecConfig, chroma: bool = False) -> np.ndarray:
    """PlaneData -> reconstructed u8 plane (host array), entropy-decoded
    on the host."""
    return np.asarray(_decode_plane_host_entropy(p, cfg, chroma))


def _decode_stripes(
    p, cfg, table, mode, n_stripes, bps, run_table=None
) -> np.ndarray:
    """Entropy-decode all stripes to (NB, n^2) zigzag coefficients.

    Uses the native C++ decoder when available (dct_tpu.native), else the
    pure-Python reference decoder.
    """
    from dct_tpu import native

    n2 = cfg.n2
    if native.available():
        return native.unpack_stripes(
            p.stripes, bps, n2, mode, table, DIRECT_VMIN, run_table=run_table
        )
    out = []
    for s in range(n_stripes):
        out.append(
            bs.unpack_stripe_host(
                p.stripes[s], bps, n2, mode,
                cat_table=table if mode == "category" else None,
                val_table=table if mode == "direct" else None,
                vmin=DIRECT_VMIN,
                run_table=run_table,
            )
        )
    return np.concatenate(out, axis=0)


class ImageCodec:
    """Grayscale single-plane codec (the reference's implicit model:
    luma-only, SURVEY.md section 1)."""

    def __init__(self, config: CodecConfig | None = None):
        self.config = config or CodecConfig()
        if self.config.chroma != "gray":
            raise ValueError("ImageCodec is grayscale; use ColorImageCodec")

    def encode(self, image: np.ndarray) -> bytes:
        if image.ndim != 2:
            raise ValueError(f"expected (H, W) grayscale, got {image.shape}")
        plane = encode_plane(image, self.config)
        c = cont.Container(
            config=self.config,
            width=int(image.shape[1]),
            height=int(image.shape[0]),
            planes=[plane],
        )
        return cont.serialize(c)

    def decode(self, data: bytes) -> np.ndarray:
        c = cont.deserialize(data)
        return decode_plane(c.planes[0], c.config)

    def decode_to_device(self, data: bytes) -> jax.Array:
        """Decode with the reconstruction left ON DEVICE (u8 jax array) —
        for on-device consumers; see decode_plane_device."""
        c = cont.deserialize(data)
        return decode_plane_device(c.planes[0], c.config)


def encode(image: np.ndarray, config: CodecConfig | None = None) -> bytes:
    """Module-level convenience: grayscale or color by array rank."""
    cfg = config or CodecConfig()
    if image.ndim == 2:
        return ImageCodec(cfg).encode(image)
    from dct_tpu.models.color import ColorImageCodec

    if cfg.chroma == "gray":
        cfg = cfg.replace(chroma="420")
    return ColorImageCodec(cfg).encode(image)


def decode(data: bytes) -> np.ndarray:
    c = cont.deserialize(data)
    if c.config.chroma == "gray":
        return decode_plane(c.planes[0], c.config)
    from dct_tpu.models.color import ColorImageCodec

    return ColorImageCodec(c.config).decode(data)
