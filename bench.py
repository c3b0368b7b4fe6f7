#!/usr/bin/env python
"""Headline benchmark: single-GPU encode and decode throughput (Mpix/s).

Workload: BASELINE.json config 2 shape — a batch of 8 grayscale 1080p
"photo" frames, q50, static tables:

  * encode: the jitted single-dispatch encode (codec.encode_step, vmapped
    over the batch: transform, RLE, chunk build, scatter pack), timed in
    a steady window that ends in block_until_ready;
  * decode_host: decode_to_device of unindexed containers (host C++
    entropy decode + int16 coefficient upload + device dequant+IDCT);
  * decode_device: decode_to_device of indexed containers (container v2:
    the lax entropy decoder on the device), checked pixel-identical to
    the host decoder first.

Requires a GPU: with no GPU it exits non-zero and prints no result. The
baseline ratio (vs_baseline) compares against the C reference's encode
pipeline (oracle_encode_batch) timed on this host, and is omitted when
the oracle cannot be built.

Prints the card (nvidia-smi) on stderr and ONE JSON line on stdout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

FRAMES = 8
H, W = 1088, 1920  # 1080p padded to the 8-px grid (136 x 240 blocks)
ITERS = 10


def measure_c_baseline() -> float | None:
    """C reference encode throughput (Mpix/s), best of 3, or None."""
    from dct_tpu import oracle

    if not oracle.available():
        return None
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (20000, 8, 8)).astype(np.uint8)
    oracle.encode_batch(px[:500], 50)  # warmup
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        oracle.encode_batch(px, 50)
        best = min(best, time.perf_counter() - t0)
    return px.shape[0] * 64 / best / 1e6


def _best_seconds(fn, iters: int = 3) -> float:
    fn()  # compile + warm
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    import jax
    import jax.numpy as jnp

    from dct_tpu.utils import compile_cache

    compile_cache.configure()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}", file=sys.stderr)

    from dct_tpu.config import CodecConfig
    from dct_tpu.models import codec
    from dct_tpu.utils import image_io

    cfg = CodecConfig(quality=50, static_tables=True)
    n_stripes = H // 8  # one block row per stripe
    frames = np.stack(
        [image_io.synthetic_image(H, W, "photo", seed=s) for s in range(FRAMES)]
    )
    frames_dev = jnp.asarray(frames)
    pixels = FRAMES * H * W

    step = jax.jit(jax.vmap(lambda im: codec.encode_step(im, cfg, n_stripes)))

    def encode_window():
        for _ in range(ITERS):
            out = step(frames_dev)
        jax.block_until_ready(out)

    enc_mpix = pixels * ITERS / _best_seconds(encode_window) / 1e6

    def decode_rate(c: CodecConfig) -> float:
        datas = [codec.ImageCodec(c).encode(f) for f in frames]
        dec = codec.ImageCodec(c)
        host = dec.decode(datas[0])
        got = np.asarray(dec.decode_to_device(datas[0]))
        if not np.array_equal(got, host):
            raise AssertionError("decode_to_device != host decode")
        return pixels / _best_seconds(
            lambda: jax.block_until_ready(
                [dec.decode_to_device(d) for d in datas]
            )
        ) / 1e6

    out = {
        "metric": "encode_throughput_1080p_batch",
        "value": round(enc_mpix, 2),
        "unit": "Mpix/s",
        "decode_host_value": round(
            decode_rate(cfg.replace(decode_index=False)), 2
        ),
        "decode_device_value": round(
            decode_rate(cfg.replace(decode_index=True)), 2
        ),
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }
    baseline = measure_c_baseline()
    if baseline is not None:
        out["vs_baseline"] = round(enc_mpix / baseline, 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
