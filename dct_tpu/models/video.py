"""Batched-frame codec ("video" model family): encode a stack of frames in
one device dispatch per stage (BASELINE.json config 2: 256 x 1080p batch).

All-intra: every frame is coded independently (the reference pipeline has no
temporal tools), but the batch shares ONE Huffman table per plane type
derived from the batch-global histogram — the multi-frame analog of the
per-image table, and the same psum-reduction shape the sharded encoder uses
across stripes. Per-frame containers stay individually decodable.

Color stacks ((F, H, W, 3) RGB with cfg.chroma '444'/'420') encode as three
plane batches (Y, Cb, Cr) with the chrominance quant table on Cb/Cr,
mirroring models/color.ColorImageCodec per frame.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dct_tpu import container as cont
from dct_tpu.config import CodecConfig
from dct_tpu.models import codec as _codec
from dct_tpu.ops import bitstream as bs


@functools.partial(jax.jit, static_argnames=("cfg", "chroma"))
def _analyze_batch(frames: jax.Array, cfg: CodecConfig, chroma: bool = False):
    symbols, var_codes, hist, run_hist = jax.vmap(
        lambda im: _codec.encode_analyze(im, cfg, chroma=chroma)
    )(frames)
    return symbols, var_codes, jnp.sum(hist, axis=0), jnp.sum(run_hist, axis=0)


@functools.partial(
    jax.jit, static_argnames=("cfg", "n_stripes", "return_block_bits")
)
def _pack_batch(symbols, cfg: CodecConfig, n_stripes: int, lengths, codes,
                run_lengths=None, run_codes=None,
                return_block_bits: bool = False):
    return jax.vmap(
        lambda s: _codec.encode_pack(
            s, cfg, n_stripes, lengths, codes, run_lengths, run_codes,
            return_block_bits=return_block_bits,
        )
    )(symbols)


# Pixels per encode/decode dispatch. The staged encode holds tens of
# bytes of device intermediates per pixel (the (B, n2, 3) u32 chunk
# values and i32 chunk lengths alone are 24 B at 8x8, plus their offset
# scans and the worst-case units buffer), so 128 Mpix bounds one chunk
# to several GB whatever the frame size: long stacks (e.g. 256 x 1080p,
# BASELINE config 2) encode in bounded memory on any device. The bound
# is in pixels, not a device's memory size, so the chunking never
# depends on the device (and output bytes are chunking-invariant).
CHUNK_PIXEL_BUDGET = 128_000_000


def _encode_plane_batch(
    planes: jax.Array,
    cfg: CodecConfig,
    chroma: bool = False,
    chunk_frames: int | None = None,
) -> list[cont.PlaneData]:
    """(F, h, w) u8 plane stack -> one PlaneData per frame.

    One batched device dispatch per stage per chunk of frames (chunks are
    sized by CHUNK_PIXEL_BUDGET unless chunk_frames is given); a single
    Huffman table (and run table) per plane TYPE shared across the WHOLE
    batch, so the output is byte-identical for every chunking: dynamic
    tables come from histograms accumulated over all chunks (pass 1), and
    pass 2 re-derives each chunk's symbols against the final tables."""
    f, h, w = (int(x) for x in planes.shape)
    bh, bw, n_stripes = _codec._padded_grid(h, w, cfg)
    n = cfg.block_size

    from dct_tpu.ops import blocks as blk

    if chunk_frames is None:
        chunk_frames = max(1, CHUNK_PIXEL_BUDGET // (h * w))
    chunk = max(1, min(int(chunk_frames), f))

    ph, pw = bh * n, bw * n

    def prep(sub):
        imgs = blk.pad_to_blocks(jnp.asarray(sub, jnp.uint8), n)
        return jnp.pad(
            imgs,
            ((0, 0), (0, ph - imgs.shape[1]), (0, pw - imgs.shape[2])),
            mode="edge",
        )

    if cfg.static_tables:
        table = _codec._build_table(cfg, None)
        run_table = _codec._build_run_table(cfg, None)
        lengths = codes = run_lengths = run_codes = None
        symbols_once = None
    elif f <= chunk:
        # single chunk: analyze once and pack the SAME symbols (no
        # recompute)
        symbols_once, var_once, hist, run_hist = _analyze_batch(
            prep(planes), cfg, chroma=chroma
        )
        table = _codec._build_table(cfg, np.asarray(hist))
        run_table = _codec._build_run_table(cfg, np.asarray(run_hist))
        lengths, codes = _codec._table_arrays(table)
        run_lengths, run_codes = (
            _codec._table_arrays(run_table) if cfg.coded_runs else (None, None)
        )
    else:
        # pass 1: batch-global histograms, chunk by chunk (symbols dropped
        # per chunk to bound device memory)
        hist = run_hist = None
        for i0 in range(0, f, chunk):
            _, _, h_, rh_ = _analyze_batch(
                prep(planes[i0 : i0 + chunk]), cfg, chroma=chroma
            )
            # accumulate in int64: device histograms are int32 and a bin
            # can exceed 2^31 counts across a very long stack
            hist = np.asarray(h_, np.int64) + (0 if hist is None else hist)
            run_hist = (
                np.asarray(rh_, np.int64)
                + (0 if run_hist is None else run_hist)
            )
        table = _codec._build_table(cfg, hist)
        run_table = _codec._build_run_table(cfg, run_hist)
        lengths, codes = _codec._table_arrays(table)
        run_lengths, run_codes = (
            _codec._table_arrays(run_table) if cfg.coded_runs else (None, None)
        )
        symbols_once = None

    out: list[cont.PlaneData] = []
    for i0 in range(0, f, chunk):
        block_bits = None
        if cfg.static_tables:
            packed, var_codes, block_bits = jax.vmap(
                lambda im: _codec.encode_step(im, cfg, n_stripes, chroma)
            )(prep(planes[i0 : i0 + chunk]))
        elif symbols_once is not None:
            # symbols already computed by the single-chunk analyze above —
            # no second pad/upload of the stack
            res = _pack_batch(
                symbols_once, cfg, n_stripes, lengths, codes,
                run_lengths, run_codes,
                return_block_bits=bool(cfg.decode_index),
            )
            packed, block_bits = res if cfg.decode_index else (res, None)
            var_codes = var_once
        else:
            symbols, var_codes, _, _ = _analyze_batch(
                prep(planes[i0 : i0 + chunk]), cfg, chroma=chroma
            )
            res = _pack_batch(
                symbols, cfg, n_stripes, lengths, codes,
                run_lengths, run_codes,
                return_block_bits=bool(cfg.decode_index),
            )
            packed, block_bits = res if cfg.decode_index else (res, None)

        packed = bs.fetch_packed(packed)  # trim worst-case slack before D2H
        units, bits = packed.units, packed.bit_lengths
        var_np = np.asarray(var_codes) if cfg.adaptive else None
        bb_np = (
            np.asarray(block_bits) if block_bits is not None else None
        )

        for i in range(units.shape[0]):
            stripes = bs.stripes_to_bytes(bs.PackedStripes(units[i], bits[i]))
            out.append(cont.PlaneData(
                width=w,
                height=h,
                table_lengths=table.lengths if table is not None else None,
                vmin=_codec.DIRECT_VMIN,
                variance_codes=var_np[i] if cfg.adaptive else None,
                stripe_bits=bits[i].astype(np.uint32),
                stripes=stripes,
                run_table_lengths=(
                    run_table.lengths if run_table is not None else None
                ),
                block_bits=(
                    bb_np[i].reshape(-1).astype(np.uint16)
                    if bb_np is not None else None
                ),
            ))
    return out


class VideoCodec:
    """Encode (F, H, W) grayscale or (F, H, W, 3) RGB u8 frame stacks;
    returns a list of per-frame containers (each independently decodable
    with models.codec.decode)."""

    def __init__(
        self,
        config: CodecConfig | None = None,
        chunk_frames: int | None = None,
        mesh=None,
    ):
        """chunk_frames caps frames per device dispatch (None = auto from
        CHUNK_PIXEL_BUDGET). Output bytes are chunking-invariant. With a
        jax.sharding.Mesh, encode runs dp x sp sharded
        (parallel/shard_encode.encode_video_sharded) and the bytes are
        mesh-shape-invariant (identical to the unsharded encoder)."""
        self.config = config or CodecConfig()
        self.chunk_frames = chunk_frames
        self.mesh = mesh

    def encode(self, frames: np.ndarray) -> list[bytes]:
        cfg = self.config
        ck = self.chunk_frames
        if self.mesh is not None:
            from dct_tpu.parallel import shard_encode as _se

            return _se.encode_video_sharded(
                frames, cfg, self.mesh, chunk_frames=ck
            )
        if cfg.chroma == "gray":
            if frames.ndim != 3:
                raise ValueError(f"expected (F, H, W), got {frames.shape}")
            f, h, w = (int(x) for x in frames.shape)
            # frames stay on host; _encode_plane_batch transfers per chunk
            per_frame = [
                [p]
                for p in _encode_plane_batch(frames, cfg, chunk_frames=ck)
            ]
        else:
            if frames.ndim != 4 or frames.shape[-1] != 3:
                raise ValueError(
                    f"expected (F, H, W, 3) RGB for chroma={cfg.chroma}, "
                    f"got {frames.shape}"
                )
            from dct_tpu.models import color as _color

            f, h, w = (int(x) for x in frames.shape[:3])
            # RGB->YCbCr in chunks too: the f32 intermediates of a whole
            # long stack would dwarf the u8 planes they produce
            cc = ck or max(1, CHUNK_PIXEL_BUDGET // (h * w))
            parts = [[], [], []]
            for i0 in range(0, f, cc):
                planes = jax.vmap(
                    lambda im: _color._to_planes(im, cfg.chroma)
                )(jnp.asarray(frames[i0 : i0 + cc], jnp.uint8))
                for lst, p in zip(parts, planes):
                    lst.append(np.asarray(p))
            y, cb, cr = (np.concatenate(lst) for lst in parts)
            ys = _encode_plane_batch(y, cfg, chroma=False, chunk_frames=ck)
            cbs = _encode_plane_batch(cb, cfg, chroma=True, chunk_frames=ck)
            crs = _encode_plane_batch(cr, cfg, chroma=True, chunk_frames=ck)
            per_frame = [[ys[i], cbs[i], crs[i]] for i in range(f)]

        return [
            cont.serialize(
                cont.Container(config=cfg, width=w, height=h, planes=planes)
            )
            for planes in per_frame
        ]

    def decode(self, streams: list[bytes]) -> np.ndarray:
        """Batched decode to a host array; entropy decode runs on the
        host (C++ thread pool)."""
        return np.asarray(self._decode(streams, device_entropy=False))

    def decode_to_device(self, streams: list[bytes]) -> jax.Array:
        """Batched decode leaving u8 frames on device — the data-loading
        path for on-device consumers (decoded frames feeding a model).
        Indexed containers entropy-decode on the device, one dispatch per
        plane type for the whole stack; others on the host (C++ thread
        pool), followed by one vmapped dequant+IDCT dispatch."""
        return self._decode(streams, device_entropy=True)

    def _decode(self, streams: list[bytes], device_entropy: bool) -> jax.Array:
        if not streams:
            raise ValueError("decode requires at least one stream")
        conts = [cont.deserialize(s) for s in streams]
        c0 = conts[0]
        cfg = c0.config

        def _key(c):
            # batched decode shares one entropy table per plane type, so
            # per-frame tables (e.g. per-image dynamic tables from
            # ImageCodec) must ALL match, not just frame dimensions
            return (c.config,) + tuple(
                (
                    p.height, p.width,
                    None if p.table_lengths is None
                    else p.table_lengths.tobytes(),
                    None if p.run_table_lengths is None
                    else p.run_table_lengths.tobytes(),
                )
                for p in c.planes
            )

        k0 = _key(c0)
        if any(_key(c) != k0 for c in conts[1:]):
            # mixed batch: decode frame by frame
            return jnp.concatenate([
                self._decode_cont_batch([c], c.config, device_entropy)
                for c in conts
            ])

        # symmetric with encode: decode long stacks in frame chunks so the
        # coefficient grids + f32 intermediates stay in bounded memory
        ck = max(1, self.chunk_frames or max(
            1, CHUNK_PIXEL_BUDGET // (c0.height * c0.width)
        ))
        if len(conts) > ck:
            return jnp.concatenate([
                self._decode_cont_batch(
                    conts[i0 : i0 + ck], cfg, device_entropy
                )
                for i0 in range(0, len(conts), ck)
            ])
        return self._decode_cont_batch(conts, cfg, device_entropy)

    def _decode_cont_batch(
        self, conts: list[cont.Container], cfg: CodecConfig,
        device_entropy: bool,
    ) -> jax.Array:
        c0 = conts[0]
        if cfg.chroma == "gray":
            return self._decode_plane_batch(
                conts, cfg, 0, False, device_entropy
            )

        from dct_tpu.models import color as _color

        y, cb, cr = (
            self._decode_plane_batch(conts, cfg, i, i > 0, device_entropy)
            for i in range(3)
        )
        h, w = c0.height, c0.width

        @jax.jit
        def recombine(yy, b, r):
            return jax.vmap(
                lambda yi, bi, ri: _color.planes_to_rgb(
                    yi, bi, ri, cfg.chroma, h, w
                )
            )(yy, b, r)

        return recombine(y, cb, cr)

    @staticmethod
    def _decode_plane_batch(
        conts: list[cont.Container], cfg: CodecConfig, plane_idx: int,
        chroma: bool, device_entropy: bool,
    ) -> jax.Array:
        """Plane `plane_idx` of every container -> (F, h, w) u8 on device.

        With device_entropy, indexed containers (container v2) decode in
        ONE device dispatch for the whole stack: the frames' stripes stack
        along the stripe axis of the device entropy decoder, followed by a
        vmapped reconstruct. Otherwise every frame is entropy-decoded on
        the host and one vmapped dequant+IDCT dispatch reconstructs the
        stack."""
        planes = [c.planes[plane_idx] for c in conts]
        p0 = planes[0]
        bh, bw, n_stripes = _codec._padded_grid(p0.height, p0.width, cfg)
        mode, table, run_table = _codec._plane_tables(p0, cfg)
        var_codes = _codec._var_codes(planes, cfg)
        arrays = None
        if device_entropy:
            arrays = _codec._device_decode_prep(planes, table, mode, run_table)
        if arrays is not None:
            return _codec._device_decode_step(
                arrays, var_codes, cfg=cfg, chroma=chroma, bh=bh, bw=bw,
                height=p0.height, width=p0.width,
            )

        bps = (bh // n_stripes) * bw
        zz = np.stack([
            _codec._decode_stripes(
                p, cfg, table, mode, n_stripes, bps, run_table
            )
            for p in planes
        ])  # (F, NB, n2)
        imgs = jax.vmap(
            lambda z, vc: _codec._reconstruct(
                z, vc, cfg, chroma, n_stripes, bh, bw
            )
        )(jnp.asarray(zz), jnp.asarray(var_codes))
        return imgs[:, : p0.height, : p0.width]
