#!/usr/bin/env python
"""Production-serving patterns: the codec as a data-plane component.

Three shapes the framework is built for (runs on a GPU or the CPU):

  1. ingest   — a stream of frames arriving one at a time, encoded with
                static tables (ONE device dispatch per frame, no host
                sync); jax's async dispatch overlaps frame k+1's host
                prep with frame k's device compute.
  2. feed     — containers decoded straight onto the device
                (decode_to_device) and consumed by a jitted model WITHOUT
                the pixels ever landing on the host: the decompressed-
                dataloader pattern for training/inference input pipelines.
  3. archive  — a long recorded stack encoded as one chunked batch
                (bounded device memory, batch-global tables), then
                spot-checked with the per-stripe integrity scan.

Usage: python examples/serving.py
"""

from __future__ import annotations

import os as _os
import sys as _sys
import time

_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO not in _sys.path:
    _sys.path.insert(0, _REPO)

import jax
import jax.numpy as jnp
import numpy as np

from dct_tpu import container as cont
from dct_tpu.config import CodecConfig
from dct_tpu.models import codec, recovery
from dct_tpu.models.video import VideoCodec
from dct_tpu.utils import compile_cache, image_io, metrics


def ingest_stream(frames: np.ndarray) -> list[bytes]:
    """Frame-at-a-time encode: static tables = one dispatch per frame."""
    cfg = CodecConfig(
        quality=60, static_tables=True, coded_runs=True, dc_prediction=True,
    )
    ic = codec.ImageCodec(cfg)
    ic.encode(frames[0])  # warmup: compile once, outside the timed loop
    out = []
    t0 = time.perf_counter()
    for f in frames:  # async dispatch overlaps host prep with device work
        out.append(ic.encode(f))
    dt = time.perf_counter() - t0
    raw = frames.size
    enc = sum(len(d) for d in out)
    print(f"ingest : {len(out)} frames, {raw / enc:5.2f}:1, "
          f"{raw / dt / 1e6:6.1f} Mpix/s wall")
    return out


def feed_model(streams: list[bytes]) -> None:
    """Decode-to-device feeding a jitted consumer: pixels never touch the
    host between the container bytes and the model."""
    vc = VideoCodec(cont.deserialize(streams[0]).config)

    @jax.jit
    def toy_model(batch):  # stand-in for a real network's first layers
        x = batch.astype(jnp.float32) / 255.0
        return jnp.mean(x, axis=(1, 2)), jnp.std(x, axis=(1, 2))

    dev_frames = vc.decode_to_device(streams)   # (F, H, W) u8 ON DEVICE
    means, stds = toy_model(dev_frames)
    print(f"feed   : {dev_frames.shape} u8 device batch -> model stats "
          f"mean[0]={float(means[0]):.4f} std[0]={float(stds[0]):.4f}")


def archive_batch(frames: np.ndarray) -> None:
    """Chunked batch encode of a long recording + integrity spot-check."""
    cfg = CodecConfig(quality=55, coded_runs=True, dc_prediction=True)
    vc = VideoCodec(cfg)  # chunk size auto-derived from the pixel budget
    streams = vc.encode(frames)
    total = sum(len(s) for s in streams)
    bad = [i for i, s in enumerate(streams) if recovery.verify(s)]
    rec = vc.decode(streams[:2])
    print(f"archive: {len(streams)} containers, {total / 1e3:.0f} kB, "
          f"corrupt={bad or 'none'}, spot PSNR "
          f"{metrics.psnr(rec, frames[:2]):.2f} dB")


def main() -> int:
    compile_cache.configure()
    print(f"backend: {jax.default_backend()}")
    frames = np.stack(
        [image_io.synthetic_image(240, 320, "photo", seed=s) for s in range(8)]
    )
    streams = ingest_stream(frames)
    feed_model(streams)
    archive_batch(frames)
    return 0


if __name__ == "__main__":
    _sys.exit(main())
