"""Sharded encode: images striped across a device mesh, deterministic
bitstreams regardless of mesh shape.

Design (SURVEY.md sections 5.7-5.8, BASELINE.json configs 4-5):

  * A frame's stripes are a property of the IMAGE (cfg.stripe_rows block
    rows each), not of the mesh: each stripe is encoded to an independent
    byte-aligned substream with a per-image Huffman table derived from the
    GLOBAL histogram. Any mesh assignment of stripes to devices therefore
    produces bit-identical containers (tested in tests/test_parallel.py —
    the codec's "race detector", SURVEY.md section 5.2).
  * Histogram globalization is the only cross-device reduction in the
    analyze phase: an integer psum, order-independent by construction.
  * The offsets table is derived from per-stripe bit lengths exchanged via
    all_gather (NCCL on GPUs) — exclusive cumsum, what a multi-node codec
    would do with an MPI allgather of stream sizes.

Two operating modes:
  * dynamic tables (default): two sharded dispatches with a 64-byte host
    sync for table construction (same structure as single-chip).
  * static tables: ONE sharded dispatch (models.codec.encode_step under
    jit-with-shardings) — the path dryrun_multichip and the scaling bench
    exercise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:  # jax >= 0.8 top-level API
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from dct_tpu import container as cont
from dct_tpu.config import CodecConfig
from dct_tpu.models import codec as _codec
from dct_tpu.ops import bitstream as bs
from dct_tpu.ops import huffman as hf
from dct_tpu.ops import entropy_decode as ed
from dct_tpu.parallel import mesh as meshlib


def _host_full(x) -> np.ndarray:
    """Device array -> full host ndarray, valid under multi-process SPMD.

    Single process: plain np.asarray. Multi-process (jax.distributed):
    shards on other hosts are not addressable, so gather them first —
    the codec analog of an MPI gather of per-rank results at the writer.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def stripe_byte_offsets(bit_lengths: jax.Array, mesh: Mesh) -> jax.Array:
    """Global byte offsets of each stripe's substream in the final payload.

    bit_lengths: (n_stripes,) sharded over the stripe axis. Explicit
    shard_map + all_gather: every device learns all lengths, computes the
    exclusive cumsum of byte sizes, and keeps its own slice. Deterministic
    for any mesh because the input ordering is the stripe index.
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(meshlib.STRIPE_AXIS),
        out_specs=P(meshlib.STRIPE_AXIS),
    )
    def f(local_bits):
        all_bits = jax.lax.all_gather(
            local_bits, meshlib.STRIPE_AXIS, tiled=True
        )  # (n_stripes,)
        nbytes = (all_bits + 7) // 8
        offs = jnp.cumsum(nbytes) - nbytes  # exclusive
        k = local_bits.shape[0]
        i = jax.lax.axis_index(meshlib.STRIPE_AXIS)
        return jax.lax.dynamic_slice(offs, (i * k,), (k,))

    return f(bit_lengths)


def global_category_histogram(
    values: jax.Array, live: jax.Array, mesh: Mesh
) -> jax.Array:
    """psum of per-shard category histograms -> identical table everywhere.

    values (B, S) / live mask (B, S) sharded over the stripe axis (leading
    block dim). Integer psum is order-independent, so the global histogram —
    and therefore the Huffman table — is identical for every mesh shape."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(meshlib.STRIPE_AXIS, None), P(meshlib.STRIPE_AXIS, None)),
        out_specs=P(),
    )
    def f(v, m):
        local = hf.category_histogram_masked(v, m)
        return jax.lax.psum(local, meshlib.STRIPE_AXIS)

    return f(values, live)


def global_run_histogram(
    runs: jax.Array, live: jax.Array, mesh: Mesh
) -> jax.Array:
    """psum of per-shard run-length histograms (coded_runs tables)."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(meshlib.STRIPE_AXIS, None), P(meshlib.STRIPE_AXIS, None)),
        out_specs=P(),
    )
    def f(r, m):
        local = hf.run_histogram_masked(r, m)
        return jax.lax.psum(local, meshlib.STRIPE_AXIS)

    return f(runs, live)


def _mesh_stripe_grid(h: int, w: int, cfg: CodecConfig, mesh: Mesh):
    """Padded grid dims with the stripe count rounded up to divide the
    mesh: (bh, bw, n_stripes, n_stripes_padded, bh_real). Mesh-pad stripes
    hold replicated edge rows; bh_real is the block-row count before mesh
    padding (histogram masking + container assembly drop the rest)."""
    bh, bw, n_stripes = _codec._padded_grid(h, w, cfg)
    n_dev = mesh.shape[meshlib.STRIPE_AXIS]
    bh_real = bh
    if n_stripes % n_dev != 0:
        n_stripes_p = -(-n_stripes // n_dev) * n_dev
        bh = n_stripes_p * cfg.stripe_rows
    else:
        n_stripes_p = n_stripes
    return bh, bw, n_stripes, n_stripes_p, bh_real


def _sharded_padded_plane(
    plane: np.ndarray, cfg: CodecConfig, mesh: Mesh, bh: int, bw: int
) -> jax.Array:
    """Pad a plane to the (mesh-padded) block grid and place it row-sharded
    over the stripe axis."""
    from dct_tpu.ops import blocks as blk

    n = cfg.block_size
    img = jnp.asarray(np.asarray(plane, np.uint8))
    img = blk.pad_to_blocks(img, n)
    ph, pw = bh * n, bw * n
    img = jnp.pad(
        img, ((0, ph - img.shape[0]), (0, pw - img.shape[1])), mode="edge"
    )
    row_sharding = NamedSharding(mesh, P(meshlib.STRIPE_AXIS, None))
    return jax.device_put(img, row_sharding)


def _dynamic_tables_sharded(
    symbols, cfg: CodecConfig, mesh: Mesh, nb_real: int
):
    """Global (mesh-invariant) Huffman tables from sharded symbols:
    (table, run_table, lengths, codes, run_lengths, run_codes).

    Histogram globalization is the collective: mesh-pad stripes (added
    only so the stripe count divides the device count) are masked out, or
    the table — and the whole container — would depend on the mesh."""
    from dct_tpu.ops.rle import RLEPositional

    if isinstance(symbols, RLEPositional):
        live = symbols.is_sym
    else:
        s_idx = jnp.arange(symbols.values.shape[1])[None, :]
        live = s_idx < symbols.counts[:, None]
    live = live & (
        jnp.arange(symbols.values.shape[0])[:, None] < nb_real
    )
    if cfg.use_huffman and cfg.huffman_mode == "category":
        hist = global_category_histogram(symbols.values, live, mesh)
    else:
        hist = _hist_fallback(symbols, cfg, nb_real)
    table = _codec._build_table(cfg, np.asarray(hist))
    if cfg.coded_runs:
        # second collective: psum the run histogram so every shard
        # derives the identical run table
        run_hist = global_run_histogram(symbols.runs, live, mesh)
        run_table = _codec._build_run_table(cfg, np.asarray(run_hist))
        run_lengths, run_codes = _codec._table_arrays(run_table)
    else:
        run_table = None
        run_lengths = run_codes = None
    lengths, codes = _codec._table_arrays(table)
    return table, run_table, lengths, codes, run_lengths, run_codes


def encode_plane_sharded(
    plane: np.ndarray, cfg: CodecConfig, mesh: Mesh, chroma: bool = False
) -> cont.PlaneData:
    """Stripe-sharded single-plane encode producing a container plane that
    is byte-identical to the single-device encoder's. chroma selects the
    chrominance quant table (color containers' Cb/Cr planes)."""
    h, w = int(plane.shape[0]), int(plane.shape[1])
    bh, bw, n_stripes, n_stripes_p, bh_real = _mesh_stripe_grid(
        h, w, cfg, mesh
    )
    img = _sharded_padded_plane(plane, cfg, mesh, bh, bw)

    block_bits = None
    if cfg.static_tables:
        table = _codec._build_table(cfg, None)
        run_table = _codec._build_run_table(cfg, None)
        packed, var_codes, block_bits = _encode_step_sharded(
            img, cfg, n_stripes_p, mesh, chroma
        )
    else:
        symbols, var_codes, _, _ = _codec.encode_analyze(img, cfg, chroma=chroma)
        table, run_table, lengths, codes, run_lengths, run_codes = (
            _dynamic_tables_sharded(symbols, cfg, mesh, bh_real * bw)
        )
        out = _codec.encode_pack(
            symbols, cfg, n_stripes_p, lengths, codes, run_lengths,
            run_codes, return_block_bits=bool(cfg.decode_index),
        )
        if cfg.decode_index:
            packed, block_bits = out
        else:
            packed = out

    # collective offsets (exercised + returned for the container writer)
    _ = stripe_byte_offsets(packed.bit_lengths, mesh)

    # container assembly happens on the host: under multi-process SPMD the
    # writer must first gather the shards living on other hosts. Gather the
    # tiny bit-lengths first and trim the units' worst-case slack on device
    # so the cross-host gather moves only payload-sized data (the same trim
    # bs.fetch_packed applies single-process).
    all_bits = _host_full(packed.bit_lengths)
    u_trim = bs.trim_units_count(all_bits, packed.units.shape[-1])
    packed = bs.PackedStripes(
        units=_host_full(packed.units[..., :u_trim]), bit_lengths=all_bits
    )
    stripes = bs.stripes_to_bytes(packed)[:n_stripes]
    return cont.PlaneData(
        width=w,
        height=h,
        table_lengths=table.lengths if table is not None else None,
        vmin=_codec.DIRECT_VMIN,
        variance_codes=(
            # bh_real, not bh: mesh-pad stripes exist only so the stripe
            # count divides the device count — their variance codes must
            # not leak into the container or bytes depend on the mesh
            _host_full(var_codes)[: bh_real * bw] if cfg.adaptive else None
        ),
        stripe_bits=np.asarray(packed.bit_lengths, np.uint32)[:n_stripes],
        stripes=stripes,
        run_table_lengths=(
            run_table.lengths if run_table is not None else None
        ),
        block_bits=(
            # per-block bit lengths are stripe-local — no collective, just
            # the same gather + mesh-pad-stripe trim as the payload
            _host_full(block_bits)[:n_stripes]
            .reshape(-1).astype(np.uint16)
            if block_bits is not None else None
        ),
    )


# ---------------------------------------------------------------------------
# Sharded rate-control probes (models/rate_control.py with a mesh)
# ---------------------------------------------------------------------------


def plane_probe_bits_sharded(
    plane: np.ndarray, cfg: CodecConfig, mesh: Mesh, chroma: bool = False
):
    """Sharded size probe: per-stripe payload bit counts WITHOUT packing —
    the mesh analog of rate_control._plane_size's bits half. Runs the
    sharded analyze + the same psum table globalization as
    encode_plane_sharded, then reduces the chunk-length tensor (the one
    the packer offsets by) per stripe. Returns
    (bits[:n_stripes], block_bits, var_codes or None, table, run_table) — the
    fields the probe skeleton needs, mesh-shape-invariant by the same
    masking that makes the encoder mesh-invariant."""
    from dct_tpu.models import rate_control as _rc

    h, w = int(plane.shape[0]), int(plane.shape[1])
    bh, bw, n_stripes, n_stripes_p, bh_real = _mesh_stripe_grid(
        h, w, cfg, mesh
    )
    img = _sharded_padded_plane(plane, cfg, mesh, bh, bw)
    symbols, var_codes, hist, run_hist = _codec.encode_analyze(
        img, cfg, chroma=chroma
    )
    if cfg.static_tables:
        table = _codec._build_table(cfg, None)
        run_table = _codec._build_run_table(cfg, None)
        lengths, codes = _codec._table_arrays(table)
        run_lengths, run_codes = (
            _codec._table_arrays(run_table) if cfg.coded_runs
            else (None, None)
        )
    else:
        table, run_table, lengths, codes, run_lengths, run_codes = (
            _dynamic_tables_sharded(symbols, cfg, mesh, bh_real * bw)
        )
    bits, bb = _rc._chunk_bits(
        symbols, cfg, n_stripes_p, lengths, codes, run_lengths, run_codes
    )
    bits = np.asarray(bits)[:n_stripes]
    # drop mesh-pad stripes' blocks (the same trim as the payload)
    bb = np.asarray(bb).reshape(n_stripes_p, -1)[:n_stripes].reshape(-1)
    vc = (
        _host_full(var_codes)[: bh_real * bw] if cfg.adaptive else None
    )
    return bits, bb, vc, table, run_table


def plane_sse_chunks_sharded(
    plane: np.ndarray, cfg: CodecConfig, mesh: Mesh, chroma: bool, h: int,
    w: int,
) -> jax.Array:
    """Sharded distortion probe: the mesh analog of
    rate_control._plane_sse_chunks. Each device round-trips ITS stripe
    rows through the production quantize/reconstruct pair (shard_map,
    so no stripe row leaves its device) and reduces to int32
    column-chunk partial sums; rows past the real image
    height (grid pad + mesh-pad stripes) and columns past the width are
    masked to zero instead of cropped, which sums to the identical exact
    integer. Output: (ph, ceil(w/4096)) int32, row-sharded."""
    bh, bw, n_stripes, n_stripes_p, bh_real = _mesh_stripe_grid(
        h, w, cfg, mesh
    )
    img = _sharded_padded_plane(plane, cfg, mesh, bh, bw)
    n = cfg.block_size
    n_dev = mesh.shape[meshlib.STRIPE_AXIS]
    ph, pw = bh * n, bw * n
    local_ph = ph // n_dev
    pad_w = -(-w // 4096) * 4096

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(meshlib.STRIPE_AXIS, None),
        out_specs=P(meshlib.STRIPE_AXIS, None),
    )
    def f(local_img):
        from dct_tpu.models.rate_control import _plane_roundtrip

        rec = _plane_roundtrip(local_img, cfg, chroma)
        d = rec.astype(jnp.int32) - local_img.astype(jnp.int32)
        sq = d * d
        row0 = jax.lax.axis_index(meshlib.STRIPE_AXIS) * local_ph
        rows = row0 + jax.lax.broadcasted_iota(
            jnp.int32, (local_ph, pw), 0
        )
        cols = jax.lax.broadcasted_iota(jnp.int32, (local_ph, pw), 1)
        sq = jnp.where((rows < h) & (cols < w), sq, 0)
        if pad_w > pw:
            sq = jnp.pad(sq, ((0, 0), (0, pad_w - pw)))
        else:
            sq = sq[:, :pad_w]
        return sq.reshape(local_ph, pad_w // 4096, 4096).sum(axis=2)

    return f(img)


def plane_roundtrip_sharded(
    plane: np.ndarray, cfg: CodecConfig, mesh: Mesh, chroma: bool
) -> jax.Array:
    """Sharded production quantize/reconstruct roundtrip of one plane:
    the mesh analog of rate_control._plane_roundtrip, returning the
    reconstructed padded plane row-sharded (callers crop). Used by the
    sharded RGB distortion probe, whose YCbCr recombine crosses stripe
    rows and therefore happens OUTSIDE the shard_map (XLA inserts the
    halo resharding for the 4:2:0 upsample)."""
    h, w = int(plane.shape[0]), int(plane.shape[1])
    bh, bw, _, _, _ = _mesh_stripe_grid(h, w, cfg, mesh)
    img = _sharded_padded_plane(plane, cfg, mesh, bh, bw)

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(meshlib.STRIPE_AXIS, None),
        out_specs=P(meshlib.STRIPE_AXIS, None),
    )
    def f(local_img):
        from dct_tpu.models.rate_control import _plane_roundtrip

        return _plane_roundtrip(local_img, cfg, chroma)

    return f(img)


def _hist_fallback(symbols, cfg, nb_real: int):
    if cfg.use_huffman and cfg.huffman_mode == "direct":
        # mesh-pad stripes must not contaminate the value histogram either
        # (same mesh-shape-invariance reasoning as the category psum path):
        # zero their per-block symbol counts before histogramming
        counts = jnp.where(
            jnp.arange(symbols.values.shape[0]) < nb_real, symbols.counts, 0
        )
        return hf.value_histogram(
            symbols.values, counts, _codec.DIRECT_VMIN, -_codec.DIRECT_VMIN
        )
    return jnp.zeros(1, jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("cfg", "n_stripes", "mesh", "chroma")
)
def _encode_step_sharded(
    img, cfg: CodecConfig, n_stripes: int, mesh: Mesh, chroma: bool = False
):
    """shard_map'd static-table encode: each device packs ITS stripes.

    shard_map (not GSPMD auto-partitioning) is load-bearing: stripes
    are independent by design, but the staged packer's scatter-add has
    data-dependent indices, and the SPMD partitioner cannot prove they
    stay shard-local — it lowers a sharded scatter to
    scatter-into-replicated + all-reduce (2 x ~123 KB for a 16-stripe
    1080p plane, measured in tests/test_collectives.py). Inside
    shard_map the scatter is a plain single-device op, and the step has
    zero collectives (asserted by tests/test_collectives.py).
    """
    n_dev = mesh.shape[meshlib.STRIPE_AXIS]
    if n_stripes % n_dev:
        # a silent floor division would re-segment stripes wrongly
        # (encode_plane_sharded pre-pads, so it never trips this)
        raise ValueError(
            f"n_stripes={n_stripes} must divide over the {n_dev}-device "
            f"stripe axis"
        )
    local_stripes = n_stripes // n_dev
    ps_spec = bs.PackedStripes(
        units=P(meshlib.STRIPE_AXIS, None),
        bit_lengths=P(meshlib.STRIPE_AXIS),
    )
    out_specs = (
        ps_spec,
        P(meshlib.STRIPE_AXIS) if cfg.adaptive else None,
        # per-block bit lengths: (n_stripes, bps), stripe-sharded like
        # the units they index (None when the index is off)
        P(meshlib.STRIPE_AXIS, None) if cfg.decode_index else None,
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(meshlib.STRIPE_AXIS, None),
        out_specs=out_specs,
    )
    def f(local_img):
        return _codec.encode_step(local_img, cfg, local_stripes, chroma)

    return f(img)


def encode_image_sharded(
    image: np.ndarray, cfg: CodecConfig, mesh: Mesh
) -> bytes:
    """Full sharded encode -> container bytes (mesh-invariant).

    Grayscale (2D input, cfg.chroma == 'gray') or color (3D RGB input,
    cfg.chroma '444'/'420'): color containers carry three planes, each
    stripe-sharded independently, byte-identical to ColorImageCodec."""
    if cfg.chroma == "gray":
        plane = encode_plane_sharded(image, cfg, mesh)
        planes = [plane]
    else:
        from dct_tpu.models import color as _color

        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) RGB, got {image.shape}")
        y, cb, cr = _color._to_planes(
            jnp.asarray(image, jnp.uint8), cfg.chroma
        )
        planes = [
            encode_plane_sharded(np.asarray(y), cfg, mesh, chroma=False),
            encode_plane_sharded(np.asarray(cb), cfg, mesh, chroma=True),
            encode_plane_sharded(np.asarray(cr), cfg, mesh, chroma=True),
        ]
    c = cont.Container(
        config=cfg,
        width=int(image.shape[1]),
        height=int(image.shape[0]),
        planes=planes,
    )
    return cont.serialize(c)


_ROWS = P(meshlib.STRIPE_AXIS, None)


@functools.partial(
    jax.jit, static_argnames=("cfg", "chroma", "mesh", "n_loc", "bh_loc", "bw")
)
def _device_decode_step_sharded(
    arrays, var_codes, cfg: CodecConfig, chroma: bool, mesh: Mesh,
    n_loc: int, bh_loc: int, bw: int,
):
    """shard_map'd DEVICE entropy decode + reconstruct: each device runs
    the entropy decoder (ops/entropy_decode.py) on ITS stripes' words and
    block lengths, then dc-unpredict + dequant+IDCT + image assembly
    locally — zero collectives (stripes are independent substreams; only
    the tiny canonical tables are replicated). The sharded mirror of
    codec._device_decode_step: a v2 container's entropy stage never runs
    on the host for any mesh shape."""
    in_specs = ((_ROWS, _ROWS) + (P(),) * 4, _ROWS)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=in_specs, out_specs=_ROWS
    )
    def step(ops, vc):
        zz = ed.decode_blocks(*ops, **_codec._entropy_statics(cfg))
        return _codec._reconstruct(
            zz, vc.reshape(-1), cfg, chroma, n_loc, bh_loc, bw
        )

    return step(arrays, var_codes)


@functools.partial(
    jax.jit, static_argnames=("cfg", "chroma", "mesh", "n_loc", "bh_loc", "bw")
)
def _decode_step_sharded(
    zz, var_codes, cfg: CodecConfig, chroma: bool, mesh: Mesh, n_loc: int,
    bh_loc: int, bw: int,
):
    """shard_map'd reconstruct of host-decoded coefficients: (NB, n2)
    coefficients and (n_stripes, bps) variance codes, both stripe-sharded
    -> row-sharded u8 image. Blocks share no pixels and DC prediction is
    stripe-local, so each device reconstructs its own block rows with
    zero collectives."""

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(_ROWS, _ROWS), out_specs=_ROWS
    )
    def step(z, vc):
        return _codec._reconstruct(
            z, vc.reshape(-1), cfg, chroma, n_loc, bh_loc, bw
        )

    return step(zz, var_codes)


def _pad_stripes(x: np.ndarray, n: int) -> np.ndarray:
    """Append n all-zero rows (mesh-pad stripes) along axis 0."""
    if not n:
        return x
    return np.concatenate([x, np.zeros((n,) + x.shape[1:], x.dtype)])


def _decode_plane_sharded(
    p: cont.PlaneData, cfg: CodecConfig, mesh: Mesh, chroma: bool = False
) -> jax.Array:
    """One container plane -> u8 pixel plane on the mesh (row-sharded).

    With a decode index (container v2) the entropy stage runs ON DEVICE
    under shard_map. Otherwise entropy decode runs on the host
    (per-stripe, C++ thread pool) and the coefficient grid is placed
    with stripes over the mesh's stripe axis. Either way ONE sharded
    dispatch reconstructs pixel rows in place — no cross-device traffic
    at all (blocks share no pixels, SURVEY.md section 5.7). Mesh-pad
    stripes (added so the stripe count divides the mesh) are all zero:
    zero-length blocks the device decoder never touches, blank rows the
    final crop discards."""
    bh, bw, n_stripes = _codec._padded_grid(p.height, p.width, cfg)
    bps = (bh // n_stripes) * bw
    mode, table, run_table = _codec._plane_tables(p, cfg)
    n_dev = mesh.shape[meshlib.STRIPE_AXIS]
    ns_pad = -(-n_stripes // n_dev) * n_dev
    pad = ns_pad - n_stripes
    n_loc = ns_pad // n_dev
    geom = dict(
        cfg=cfg, chroma=chroma, mesh=mesh, n_loc=n_loc,
        bh_loc=n_loc * (bh // n_stripes), bw=bw,
    )
    rows = NamedSharding(mesh, _ROWS)
    if cfg.adaptive:
        vc = np.asarray(p.variance_codes, np.uint8).reshape(n_stripes, bps)
    else:
        vc = np.zeros((n_stripes, 1), np.uint8)
    vc = jax.device_put(_pad_stripes(vc, pad), rows)

    arrays = _codec._device_decode_prep([p], table, mode, run_table)
    if arrays is not None:
        words, block_bits, *tabs = arrays
        ops = (
            jax.device_put(_pad_stripes(words, pad), rows),
            jax.device_put(_pad_stripes(block_bits, pad), rows),
            *(jnp.asarray(t) for t in tabs),
        )
        img = _device_decode_step_sharded(ops, vc, **geom)
    else:
        zz = _codec._decode_stripes(
            p, cfg, table, mode, n_stripes, bps, run_table
        )  # (NB, n2)
        zz = jax.device_put(_pad_stripes(zz, pad * bps), rows)
        img = _decode_step_sharded(zz, vc, **geom)
    return img[: p.height, : p.width]


def decode_image_sharded(data: bytes, mesh: Mesh) -> jax.Array:
    """Sharded decode: container bytes -> u8 pixels on the mesh.

    The mirror of encode_image_sharded. Grayscale containers return a
    row-sharded (H, W) plane; color containers decode each plane sharded,
    then upsample + YCbCr->RGB in one jitted dispatch (XLA inserts any
    resharding the differently-sized chroma grids need). np.asarray() the
    result to land on host. A container v2 decode index sends the
    entropy stage to the devices too."""
    c = cont.deserialize(data)
    cfg = c.config
    if cfg.chroma == "gray":
        return _decode_plane_sharded(c.planes[0], cfg, mesh)

    from dct_tpu.models import color as _color

    y = _decode_plane_sharded(c.planes[0], cfg, mesh, chroma=False)
    cb = _decode_plane_sharded(c.planes[1], cfg, mesh, chroma=True)
    cr = _decode_plane_sharded(c.planes[2], cfg, mesh, chroma=True)
    h, w = c.height, c.width

    @jax.jit
    def recombine(yy, b, r):
        return _color.planes_to_rgb(yy, b, r, cfg.chroma, h, w)

    return recombine(y, cb, cr)


# ---------------------------------------------------------------------------
# Sharded video encode (models/video.py with a mesh): dp x sp over frame
# stacks, byte-identical to the unsharded VideoCodec for every mesh shape
# ---------------------------------------------------------------------------


def _pad_frames(sub: np.ndarray, cfg: CodecConfig, ph: int, pw: int,
                f_pad: int) -> jnp.ndarray:
    """Pad a frame-chunk to the (mesh-padded) grid dims and to f_pad
    frames (repeating the last frame — outputs of pad frames are dropped
    and their histogram contributions masked)."""
    from dct_tpu.ops import blocks as blk

    imgs = blk.pad_to_blocks(jnp.asarray(sub, jnp.uint8), cfg.block_size)
    imgs = jnp.pad(
        imgs,
        ((0, 0), (0, ph - imgs.shape[1]), (0, pw - imgs.shape[2])),
        mode="edge",
    )
    if f_pad > imgs.shape[0]:
        imgs = jnp.concatenate(
            [imgs] + [imgs[-1:]] * (f_pad - imgs.shape[0])
        )
    return imgs


@functools.lru_cache(maxsize=None)
def _video_hist_step(
    cfg: CodecConfig, mesh: Mesh, nb_real: int, chroma: bool, f_real: int,
    f_pad: int,
):
    """Jitted shard_map'd pass-1 step: (f_pad, ph, pw) frames sharded
    (data, stripe) -> batch-global (category or direct) histogram [+ run
    histogram], psum'd over BOTH axes with pad frames and mesh-pad
    stripes masked out — so the table (and the bytes) cannot depend on
    the mesh shape or the frame padding."""
    from dct_tpu.ops.rle import RLEPositional

    out_specs = (P(), P()) if cfg.coded_runs else (P(), None)

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS, None),
        out_specs=out_specs,
    )
    def step(fr):
        def one(im):
            symbols, _, _, _ = _codec.encode_analyze(im, cfg, chroma=chroma)
            return symbols
        sym = jax.vmap(one)(fr)

        if isinstance(sym, RLEPositional):
            live = sym.is_sym  # (F_l, B_l, S)
        else:
            s_idx = jnp.arange(sym.values.shape[2])[None, None, :]
            live = s_idx < sym.counts[:, :, None]
        f_l, b_l = live.shape[0], live.shape[1]
        # global indices: mask pad frames and mesh-pad-stripe blocks
        fidx = (
            jax.lax.axis_index(meshlib.DATA_AXIS) * f_l
            + jnp.arange(f_l)[:, None]
        )
        bidx = (
            jax.lax.axis_index(meshlib.STRIPE_AXIS) * b_l
            + jnp.arange(b_l)[None, :]
        )
        real = (fidx < f_real) & (bidx < nb_real)  # (F_l, B_l)
        live = live & real[:, :, None]

        v2 = sym.values.reshape(f_l * b_l, -1)
        m2 = live.reshape(f_l * b_l, -1)
        if cfg.use_huffman and cfg.huffman_mode == "category":
            hist = hf.category_histogram_masked(v2, m2)
        elif cfg.use_huffman and cfg.huffman_mode == "direct":
            # mirror _hist_fallback: zero the per-block symbol COUNTS of
            # masked blocks (pad frames / mesh-pad stripes)
            cnt = jnp.where(real, sym.counts, 0).reshape(-1)
            hist = hf.value_histogram(
                v2, cnt, _codec.DIRECT_VMIN, -_codec.DIRECT_VMIN
            )
        else:
            hist = jnp.zeros(1, jnp.int32)
        hist = jax.lax.psum(
            jax.lax.psum(hist, meshlib.DATA_AXIS), meshlib.STRIPE_AXIS
        )
        if cfg.coded_runs:
            rh = hf.run_histogram_masked(sym.runs.reshape(f_l * b_l, -1), m2)
            rh = jax.lax.psum(
                jax.lax.psum(rh, meshlib.DATA_AXIS), meshlib.STRIPE_AXIS
            )
            return hist, rh
        return hist, None

    return step


@functools.lru_cache(maxsize=None)
def _video_encode_step(
    cfg: CodecConfig, n_stripes: int, mesh: Mesh, chroma: bool,
    static: bool,
):
    """Jitted shard_map'd pass-2 step over a (f_pad, ph, pw) chunk:
    static tables -> vmapped encode_step; dynamic -> vmapped analyze +
    staged pack against the (replicated) global tables. Returns
    (PackedStripes, var_codes or None, block_bits or None) sharded
    (data, stripe)."""
    n_dev = mesh.shape[meshlib.STRIPE_AXIS]
    if n_stripes % n_dev:
        raise ValueError(
            f"n_stripes={n_stripes} must divide over the {n_dev}-device "
            f"stripe axis"
        )
    local_stripes = n_stripes // n_dev
    ps_spec = bs.PackedStripes(
        units=P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS, None),
        bit_lengths=P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS),
    )
    out_specs = (
        ps_spec,
        P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS) if cfg.adaptive else None,
        P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS, None)
        if cfg.decode_index else None,
    )

    if static:
        @jax.jit
        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS, None),
            out_specs=out_specs,
        )
        def step(fr):
            return jax.vmap(
                lambda im: _codec.encode_step(im, cfg, local_stripes, chroma)
            )(fr)

        return step

    table_spec = (P(), P())
    run_spec = (P(), P()) if cfg.coded_runs else (None, None)

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS, None),
            *table_spec, *run_spec,
        ),
        out_specs=out_specs,
    )
    def step(fr, lengths, codes, run_lengths, run_codes):
        def one(im):
            symbols, var_codes, _, _ = _codec.encode_analyze(
                im, cfg, chroma=chroma
            )
            out = _codec.encode_pack(
                symbols, cfg, local_stripes, lengths, codes,
                run_lengths, run_codes,
                return_block_bits=bool(cfg.decode_index),
            )
            if cfg.decode_index:
                packed, bb = out
                return packed, var_codes, bb
            return out, var_codes, None

        return jax.vmap(one)(fr)

    return step


@functools.lru_cache(maxsize=None)
def _video_bits_step(
    cfg: CodecConfig, n_stripes: int, mesh: Mesh, chroma: bool
):
    """Jitted shard_map'd size-probe step: per-frame (per-stripe,
    per-block) payload bit counts against the (replicated) tables — the
    sharded analog of rate_control._chunk_bits_batch."""
    from dct_tpu.models import rate_control as _rc

    n_dev = mesh.shape[meshlib.STRIPE_AXIS]
    local_stripes = n_stripes // n_dev
    run_spec = (P(), P()) if cfg.coded_runs else (None, None)

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS, None),
            P(), P(), *run_spec,
        ),
        out_specs=(
            P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS),
            P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS),
        ),
    )
    def step(fr, lengths, codes, run_lengths, run_codes):
        def one(im):
            symbols, _, _, _ = _codec.encode_analyze(im, cfg, chroma=chroma)
            bits, bb = _rc._chunk_bits(
                symbols, cfg, local_stripes, lengths, codes,
                run_lengths, run_codes,
            )
            # (NB_local,) -> (local_stripes, bps) so the stripe axis is
            # leading for the out_specs
            return bits, bb.reshape(local_stripes, -1)

        return jax.vmap(one)(fr)

    return step


def _video_chunks(f: int, h: int, w: int, mesh: Mesh,
                  chunk_frames: int | None) -> int:
    """Frames per sharded dispatch: the unsharded CHUNK_PIXEL_BUDGET rule
    rounded up to a data-axis multiple (pad frames are masked/dropped)."""
    from dct_tpu.models import video as _video

    n_data = mesh.shape[meshlib.DATA_AXIS]
    if chunk_frames is None:
        chunk_frames = max(1, _video.CHUNK_PIXEL_BUDGET // (h * w))
    chunk = max(1, min(int(chunk_frames), f))
    return -(-chunk // n_data) * n_data


def _video_tables_sharded(
    planes: np.ndarray, cfg: CodecConfig, mesh: Mesh, chroma: bool,
    chunk: int, ph: int, pw: int, nb_real: int,
):
    """Pass 1 under the mesh: batch-global tables from the masked, psum'd
    per-chunk histograms (int64 host accumulation across chunks, like the
    unsharded encoder)."""
    f = int(planes.shape[0])
    n_data = mesh.shape[meshlib.DATA_AXIS]
    hist = run_hist = None
    for i0 in range(0, f, chunk):
        sub = planes[i0 : i0 + chunk]
        f_real = int(sub.shape[0])
        f_pad = -(-f_real // n_data) * n_data
        fr = jax.device_put(
            _pad_frames(sub, cfg, ph, pw, f_pad), meshlib.frame_sharding(mesh)
        )
        step = _video_hist_step(cfg, mesh, nb_real, chroma, f_real, f_pad)
        h_, rh_ = step(fr)
        hist = np.asarray(h_, np.int64) + (0 if hist is None else hist)
        if rh_ is not None:
            run_hist = (
                np.asarray(rh_, np.int64)
                + (0 if run_hist is None else run_hist)
            )
    table = _codec._build_table(cfg, hist)
    run_table = _codec._build_run_table(cfg, run_hist)
    return table, run_table


def encode_video_plane_batch_sharded(
    planes: np.ndarray,
    cfg: CodecConfig,
    mesh: Mesh,
    chroma: bool = False,
    chunk_frames: int | None = None,
) -> list[cont.PlaneData]:
    """(F, h, w) u8 plane stack -> one PlaneData per frame, dp x sp
    sharded, byte-identical to video._encode_plane_batch for every mesh
    shape (batch-GLOBAL tables via masked psum histograms; mesh-pad
    stripes and pad frames contribute nothing)."""
    f, h, w = (int(x) for x in planes.shape)
    bh, bw, n_stripes, n_stripes_p, bh_real = _mesh_stripe_grid(
        h, w, cfg, mesh
    )
    n = cfg.block_size
    ph, pw = bh * n, bw * n
    n_data = mesh.shape[meshlib.DATA_AXIS]
    chunk = _video_chunks(f, h, w, mesh, chunk_frames)

    if cfg.static_tables:
        table = _codec._build_table(cfg, None)
        run_table = _codec._build_run_table(cfg, None)
    else:
        table, run_table = _video_tables_sharded(
            planes, cfg, mesh, chroma, chunk, ph, pw, bh_real * bw
        )
    lengths, codes = _codec._table_arrays(table)
    run_lengths, run_codes = (
        _codec._table_arrays(run_table) if cfg.coded_runs else (None, None)
    )

    step = _video_encode_step(
        cfg, n_stripes_p, mesh, chroma, static=cfg.static_tables
    )

    out: list[cont.PlaneData] = []
    for i0 in range(0, f, chunk):
        sub = planes[i0 : i0 + chunk]
        f_real = int(sub.shape[0])
        f_pad = -(-f_real // n_data) * n_data
        fr = jax.device_put(
            _pad_frames(sub, cfg, ph, pw, f_pad), meshlib.frame_sharding(mesh)
        )
        if cfg.static_tables:
            res = step(fr)
        else:
            res = step(fr, lengths, codes, run_lengths, run_codes)
        packed, var_codes, block_bits = res

        all_bits = _host_full(packed.bit_lengths)
        u_trim = bs.trim_units_count(all_bits, packed.units.shape[-1])
        units = _host_full(packed.units[..., :u_trim])
        var_np = _host_full(var_codes) if cfg.adaptive else None
        bb_np = _host_full(block_bits) if block_bits is not None else None

        for i in range(f_real):
            ps = bs.PackedStripes(
                units[i, :n_stripes], all_bits[i, :n_stripes]
            )
            out.append(cont.PlaneData(
                width=w,
                height=h,
                table_lengths=table.lengths if table is not None else None,
                vmin=_codec.DIRECT_VMIN,
                variance_codes=(
                    var_np[i][: bh_real * bw] if cfg.adaptive else None
                ),
                stripe_bits=np.asarray(
                    all_bits[i, :n_stripes], np.uint32
                ),
                stripes=bs.stripes_to_bytes(ps),
                run_table_lengths=(
                    run_table.lengths if run_table is not None else None
                ),
                block_bits=(
                    bb_np[i, :n_stripes].reshape(-1).astype(np.uint16)
                    if bb_np is not None else None
                ),
            ))
    return out


def encode_video_sharded(
    frames: np.ndarray,
    cfg: CodecConfig,
    mesh: Mesh,
    chunk_frames: int | None = None,
) -> list[bytes]:
    """Sharded VideoCodec.encode: (F, H, W) grayscale or (F, H, W, 3) RGB
    -> per-frame containers, byte-identical to the unsharded VideoCodec
    for every mesh shape."""
    from dct_tpu.models import video as _video

    if cfg.chroma == "gray":
        if frames.ndim != 3:
            raise ValueError(f"expected (F, H, W), got {frames.shape}")
        f, h, w = (int(x) for x in frames.shape)
        per_frame = [
            [p]
            for p in encode_video_plane_batch_sharded(
                np.asarray(frames, np.uint8), cfg, mesh,
                chunk_frames=chunk_frames,
            )
        ]
    else:
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(
                f"expected (F, H, W, 3) RGB for chroma={cfg.chroma}, "
                f"got {frames.shape}"
            )
        from dct_tpu.models import rate_control as _rc

        f, h, w = (int(x) for x in frames.shape[:3])
        batches = _rc._video_plane_batches(frames, cfg, chunk_frames)
        per_plane = [
            encode_video_plane_batch_sharded(
                batch, cfg, mesh, chroma=chroma, chunk_frames=chunk_frames
            )
            for batch, chroma in batches
        ]
        per_frame = [[pp[i] for pp in per_plane] for i in range(f)]
    return [
        cont.serialize(
            cont.Container(config=cfg, width=w, height=h, planes=planes)
        )
        for planes in per_frame
    ]


def video_plane_batch_bits_sharded(
    planes: np.ndarray,
    cfg: CodecConfig,
    mesh: Mesh,
    chroma: bool,
    chunk_frames: int | None,
):
    """Sharded video size probe: ((F, n_stripes) per-stripe bit counts,
    (F, NB) per-block bit counts, table, run_table) — the mesh analog of
    rate_control._plane_batch_bits, mesh-shape-invariant and equal to
    the unsharded counts."""
    f, h, w = (int(x) for x in planes.shape)
    bh, bw, n_stripes, n_stripes_p, bh_real = _mesh_stripe_grid(
        h, w, cfg, mesh
    )
    n = cfg.block_size
    ph, pw = bh * n, bw * n
    n_data = mesh.shape[meshlib.DATA_AXIS]
    chunk = _video_chunks(f, h, w, mesh, chunk_frames)

    if cfg.static_tables:
        table = _codec._build_table(cfg, None)
        run_table = _codec._build_run_table(cfg, None)
    else:
        table, run_table = _video_tables_sharded(
            planes, cfg, mesh, chroma, chunk, ph, pw, bh_real * bw
        )
    lengths, codes = _codec._table_arrays(table)
    run_lengths, run_codes = (
        _codec._table_arrays(run_table) if cfg.coded_runs else (None, None)
    )
    step = _video_bits_step(cfg, n_stripes_p, mesh, chroma)
    bits = []
    bbs = []
    for i0 in range(0, f, chunk):
        sub = planes[i0 : i0 + chunk]
        f_real = int(sub.shape[0])
        f_pad = -(-f_real // n_data) * n_data
        fr = jax.device_put(
            _pad_frames(sub, cfg, ph, pw, f_pad), meshlib.frame_sharding(mesh)
        )
        b, bb = step(fr, lengths, codes, run_lengths, run_codes)
        bits.append(np.asarray(b)[:f_real, :n_stripes])
        # (F, n_stripes_p, bps) -> real stripes only, flattened per frame
        bbs.append(
            np.asarray(bb)[:f_real, :n_stripes].reshape(f_real, -1)
        )
    return (
        np.concatenate(bits, axis=0), np.concatenate(bbs, axis=0),
        table, run_table,
    )


# ---------------------------------------------------------------------------
# Batched multi-frame sharded encode (dp x sp) — the "training step" analog
# ---------------------------------------------------------------------------


def encode_batch_step(
    frames: jax.Array, cfg: CodecConfig, n_stripes: int, mesh: Mesh
):
    """One fully-jitted sharded step over a batch of frames.

    frames: (F, Hp, Wp) u8, sharded (data, stripe, -). Static tables.
    Returns PackedStripes batched over frames: units (F, S, U) and
    bit_lengths (F, S), sharded (data, stripe[, -]).

    This is the codec's equivalent of a sharded training step: pure SPMD
    compute + one collective family (none needed for static tables; the
    offset exchange happens in stripe_byte_offsets when assembling).
    """

    step = _batch_step(cfg, n_stripes, mesh)
    frames = jax.device_put(frames, meshlib.frame_sharding(mesh))
    return step(frames)


@functools.lru_cache(maxsize=None)
def _batch_step(cfg: CodecConfig, n_stripes: int, mesh: Mesh):
    """Jitted shard_map'd dp x sp step (cached per config/mesh; also
    lowered directly by tests/test_collectives.py to pin zero collectives
    in the compiled HLO — same reasoning as _encode_step_sharded)."""
    n_dev = mesh.shape[meshlib.STRIPE_AXIS]
    if n_stripes % n_dev:
        raise ValueError(
            f"n_stripes={n_stripes} must divide over the {n_dev}-device "
            f"stripe axis (a floor division would re-segment stripes)"
        )
    local_stripes = n_stripes // n_dev
    ps_spec = bs.PackedStripes(
        units=P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS, None),
        bit_lengths=P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS),
    )

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(meshlib.DATA_AXIS, meshlib.STRIPE_AXIS, None),
        out_specs=ps_spec,
    )
    def step(fr):
        packed = jax.vmap(
            lambda im: _codec.encode_step(im, cfg, local_stripes)
        )(fr)[0]
        return packed

    return step
