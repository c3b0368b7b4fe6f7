#!/usr/bin/env python
"""End-to-end tour of the dct_tpu API.

Runs on whatever backend jax picks (a GPU, or the CPU; containers are
byte-identical across backends). Covers:

  1. one-liner encode/decode (grayscale + RGB)
  2. config knobs (quality, adaptive, static tables, stripe size)
  3. per-stripe recovery: corrupt -> verify -> repair -> byte-identical
  4. random-access region decode
  5. sharded encode over a device mesh (mesh-invariant bytes)
  6. batched video-style encode

Usage: python examples/demo.py
"""

from __future__ import annotations

import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)

import numpy as np


def main() -> int:
    import jax

    import dct_tpu
    from dct_tpu.models import codec, recovery
    from dct_tpu.models.video import VideoCodec
    from dct_tpu.utils import compile_cache, image_io, metrics

    compile_cache.configure()
    print(f"backend: {jax.default_backend()}, devices: {len(jax.devices())}")

    # -- 1. one-liners ------------------------------------------------------
    gray = image_io.synthetic_image(240, 320, "photo", seed=0)
    data = dct_tpu.encode(gray)  # defaults: q50, grayscale by rank
    rec = dct_tpu.decode(data)
    print(f"gray 320x240  -> {len(data):6d} B "
          f"({gray.size / len(data):5.2f}:1)  PSNR {metrics.psnr(gray, rec):5.2f} dB")

    rgb = np.stack([gray, np.roll(gray, 7, 0), np.roll(gray, 13, 1)], -1)
    data = dct_tpu.encode(rgb, dct_tpu.CodecConfig(quality=75, chroma="420"))
    rec = dct_tpu.decode(data)
    print(f"rgb  320x240  -> {len(data):6d} B "
          f"({rgb.size / len(data):5.2f}:1)  PSNR {metrics.psnr(rgb, rec):5.2f} dB")

    # -- 2. knobs ------------------------------------------------------------
    for cfg in (
        dct_tpu.CodecConfig(quality=10),
        dct_tpu.CodecConfig(quality=90, adaptive=True),
        dct_tpu.CodecConfig(quality=50, static_tables=True),  # 1-dispatch
        dct_tpu.CodecConfig(quality=50, coded_runs=True),  # ~42% smaller
        dct_tpu.CodecConfig(  # smallest files: coded runs + DC DPCM
            quality=50, coded_runs=True, dc_prediction=True
        ),
    ):
        d = dct_tpu.encode(gray, cfg)
        r = dct_tpu.decode(d)
        print(f"  q={cfg.quality:3d} adaptive={int(cfg.adaptive)} "
              f"static={int(cfg.static_tables)} coded_runs="
              f"{int(cfg.coded_runs)} dc_pred={int(cfg.dc_prediction)}: "
              f"{len(d):6d} B, PSNR {metrics.psnr(gray, r):5.2f} dB")

    # -- 3. recovery ----------------------------------------------------------
    cfg = dct_tpu.CodecConfig(quality=60, static_tables=True)
    pristine = codec.ImageCodec(cfg).encode(gray)
    damaged = bytearray(pristine)
    damaged[-30:-22] = b"\xa5" * 8  # clobber part of the last stripe
    bad = recovery.verify(bytes(damaged))
    fixed = recovery.repair(bytes(damaged), gray)
    print(f"recovery: corrupt stripes {bad} -> repaired == pristine: "
          f"{fixed == pristine}")

    # -- 4. random access ------------------------------------------------------
    band = recovery.decode_region(pristine, 100, 140)
    full = codec.ImageCodec(cfg).decode(pristine)
    print(f"region decode rows [100,140): matches full decode: "
          f"{np.array_equal(band, full[100:140])}")

    # -- 5. sharded encode ------------------------------------------------------
    if len(jax.devices()) > 1:
        from dct_tpu.parallel import mesh as meshlib
        from dct_tpu.parallel import shard_encode

        mesh = meshlib.make_mesh(n_data=1, n_stripe=len(jax.devices()))
        sharded = shard_encode.encode_image_sharded(gray, cfg, mesh)
        single = codec.ImageCodec(cfg).encode(gray)
        print(f"sharded over {len(jax.devices())} devices == single-device "
              f"bytes: {sharded == single}")
    else:
        print("sharded encode: skipped (1 device; tests use an 8-way CPU mesh)")

    # -- 6. video -------------------------------------------------------------
    frames = np.stack([
        image_io.synthetic_image(120, 160, "photo", seed=s) for s in range(4)
    ])
    streams = VideoCodec(dct_tpu.CodecConfig(quality=70)).encode(frames)
    recs = VideoCodec(dct_tpu.CodecConfig(quality=70)).decode(streams)
    print(f"video: 4 frames -> {sum(len(s) for s in streams)} B total, "
          f"PSNR {metrics.psnr(frames, recs):5.2f} dB")

    # -- 7. rate control --------------------------------------------------------
    from dct_tpu.models import rate_control

    budget = 12_000
    capped, q = rate_control.encode_to_size(
        gray, budget, dct_tpu.CodecConfig(adaptive=True)
    )
    rec = dct_tpu.decode(capped)
    print(f"rate control: <= {budget} B -> quality {q}, {len(capped)} B, "
          f"PSNR {metrics.psnr(gray, rec):5.2f} dB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
