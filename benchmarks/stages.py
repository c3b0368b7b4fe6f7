#!/usr/bin/env python
"""Stage-ladder benchmark: times each pipeline stage cumulatively on the
current backend, matching bench.py's workload (batched 1080p frames).

Timing methodology: every jitted ladder rung reduces its outputs to scalars
ON DEVICE and the loop fetches one scalar per iteration, so the rung's
whole pipeline runs while fetching full buffers would time the host link
instead of the device.

Usage: python benchmarks/stages.py [--frames 8] [--size 1920x1088]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:  # allow `python benchmarks/<x>.py` from anywhere
    _sys.path.insert(0, _REPO_ROOT)

import argparse
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", default="1920x1088")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--quality", type=int, default=50)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from dct_tpu.config import CodecConfig
    from dct_tpu.models import codec
    from dct_tpu.ops import bitstream as bs
    from dct_tpu.ops import blocks as blk
    from dct_tpu.ops import huffman as hf
    from dct_tpu.ops import rle as rlemod
    from dct_tpu.ops import transform
    from dct_tpu.utils import image_io

    w, h = (int(x) for x in args.size.split("x"))
    F = args.frames
    cfg = CodecConfig(quality=args.quality, static_tables=True)
    n_stripes = h // 8
    pixels = F * h * w

    frames = np.stack(
        [image_io.synthetic_image(h, w, "photo", seed=s) for s in range(F)]
    )
    fd = jnp.asarray(frames)

    table = hf.default_category_table()
    L = jnp.asarray(table.lengths, jnp.int32)
    Cc = jnp.asarray(table.codes.astype(np.int64), jnp.uint32)

    def tile(fr):
        return jax.vmap(lambda im: blk.image_to_blocks(im, 8))(fr)

    def enc(fr):
        px = tile(fr)
        return jax.vmap(lambda p: transform.encode_blocks(p, cfg))(px)

    def rle_s(fr):
        zz = enc(fr)
        return jax.vmap(rlemod.rle_encode_positional)(zz)

    def chunks(fr):
        sym = rle_s(fr)
        return jax.vmap(
            lambda s: bs.symbol_chunks(s, "category", cat_lengths=L, cat_codes=Cc)
        )(sym)

    def full(fr):
        packed = jax.vmap(lambda im: codec.encode_step(im, cfg, n_stripes))(fr)[0]
        return packed

    ladder = [
        ("transform", lambda fr: jnp.sum(enc(fr).astype(jnp.int32))),
        ("+ rle", lambda fr: (lambda s: jnp.sum(s.values) + jnp.sum(s.runs))(rle_s(fr))),
        ("+ chunks", lambda fr: (lambda cvcl: jnp.sum(cvcl[0].astype(jnp.int32)) + jnp.sum(cvcl[1]))(chunks(fr))),
        ("full encode_step", lambda fr: (lambda p: jnp.sum(p.units.astype(jnp.int32)) + jnp.sum(p.bit_lengths))(full(fr))),
    ]

    print(f"backend={jax.default_backend()} frames={F} size={w}x{h}",
          flush=True)
    prev = 0.0
    for name, f in ladder:
        jf = jax.jit(f)
        float(jf(fd))  # compile+warmup
        t0 = time.perf_counter()
        for _ in range(args.iters):
            float(jf(fd))
        dt = (time.perf_counter() - t0) / args.iters
        print(
            f"{name:20s}: {dt*1e3:9.2f} ms  {pixels/dt/1e6:9.1f} Mpix/s  "
            f"(+{(dt-prev)*1e3:7.2f} ms)",
            flush=True,
        )
        prev = dt
    return 0


if __name__ == "__main__":
    sys.exit(main())
