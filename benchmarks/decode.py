#!/usr/bin/env python
"""Decode throughput: TPDC container -> u8 frames, Mpix/s.

Decode is a host/device pipeline: per-stripe canonical-Huffman entropy
decode on the host (native C++ thread pool across stripes, falling back to
the pure-Python reference decoder) feeding the fused dequant+IDCT matmul on
the device. This benchmark times the full path and its two halves so the
host/device split is visible, and compares against the C reference's own
decode (run_length_decode -> dequantize -> dct_inverse at -O2) when the
oracle builds.

Usage: python benchmarks/decode.py [--frames 4] [--size 1920x1088]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:  # allow `python benchmarks/<x>.py` from anywhere
    _sys.path.insert(0, _REPO_ROOT)

import argparse
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", default="1920x1088")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--quality", type=int, default=50)
    args = ap.parse_args()

    import jax

    from dct_tpu import container as cont
    from dct_tpu import native
    from dct_tpu.config import CodecConfig
    from dct_tpu.models import codec
    from dct_tpu.utils import image_io

    w, h = (int(x) for x in args.size.split("x"))
    cfg = CodecConfig(quality=args.quality, static_tables=True)

    frames = [
        image_io.synthetic_image(h, w, "photo", seed=s) for s in range(args.frames)
    ]
    blobs = [codec.ImageCodec(cfg).encode(f) for f in frames]
    pixels = args.frames * h * w
    print(
        f"backend={jax.default_backend()} native_decoder={native.available()} "
        f"frames={args.frames} size={w}x{h} "
        f"bytes={sum(len(b) for b in blobs)}",
        flush=True,
    )

    # full decode (host entropy + device IDCT + both transfers), warm;
    # the device-compute number below is the device's own decode rate for
    # on-device consumers.
    dec = codec.ImageCodec(cfg)
    recs = [dec.decode(b) for b in blobs]  # warmup/compile
    t0 = time.perf_counter()
    for _ in range(args.iters):
        for b in blobs:
            dec.decode(b)
    dt = (time.perf_counter() - t0) / args.iters
    print(f"full (incl link) : {dt*1e3:9.2f} ms  {pixels/dt/1e6:9.1f} Mpix/s")

    # device half: dequant+IDCT, dispatch-corrected K-loop delta with an
    # on-device scalar reduce (bench.py methodology)
    import jax.numpy as jnp

    from dct_tpu.models import recovery
    from dct_tpu.ops import transform

    c0 = cont.deserialize(blobs[0])
    p0_ = c0.planes[0]
    _, _, ns_, bps_ = recovery._geometry(p0_, c0.config)
    mode_, tbl_, _run_tbl = recovery._table(p0_, c0.config)
    zz_host = codec._decode_stripes(p0_, c0.config, tbl_, mode_, ns_, bps_)
    zz_dev = jnp.asarray(np.broadcast_to(
        zz_host, (args.frames,) + zz_host.shape
    ).copy())

    def make_idct(k):
        @jax.jit
        def run(z):
            def body(i, acc):
                # every trip computes on distinct data (z + i), so no two
                # loop bodies can be CSE'd/collapsed by XLA
                zi = z + i
                px = jax.vmap(
                    lambda zz: transform.decode_blocks(zz, c0.config)
                )(zi)
                return acc + jnp.sum(px.astype(jnp.int32))

            return jax.lax.fori_loop(0, k, body, jnp.int32(0))

        return run

    # the IDCT body is ~0.2 ms — far below the ~2 ms dispatch jitter — so
    # the trip-count delta needs a much larger K than bench.py's encode
    K = 65
    r1, rk = make_idct(1), make_idct(K)

    def timed(fn, iters=4):
        float(fn(zz_dev))
        t0 = time.perf_counter()
        for _ in range(iters):
            float(fn(zz_dev))
        return (time.perf_counter() - t0) / iters

    t1_, tk_ = timed(r1), timed(rk)
    if tk_ <= t1_:
        print("warning: idct K-loop delta <= 0 (dispatch jitter); "
              "reporting single-dispatch time incl. overhead",
              file=_sys.stderr)
        dt_d = t1_
    else:
        dt_d = (tk_ - t1_) / (K - 1)
    print(f"idct (device)    : {dt_d*1e3:9.2f} ms  {pixels/dt_d/1e6:9.1f} Mpix/s")

    # host half: entropy decode only
    parsed = [cont.deserialize(b) for b in blobs]
    p0 = parsed[0].planes[0]
    ccfg = parsed[0].config
    _, _, n_stripes, bps = recovery._geometry(p0, ccfg)
    mode, table, _run = recovery._table(p0, ccfg)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        for c in parsed:
            codec._decode_stripes(c.planes[0], ccfg, table, mode, n_stripes, bps)
    dt_h = (time.perf_counter() - t0) / args.iters
    print(f"entropy (host)   : {dt_h*1e3:9.2f} ms  {pixels/dt_h/1e6:9.1f} Mpix/s")

    # sanity: reconstruction really happened
    for f, r in zip(frames, recs):
        assert r.shape == f.shape
    from dct_tpu.utils import metrics

    print(f"PSNR frame0      : {float(metrics.psnr(frames[0], recs[0])):9.2f} dB")

    # C reference decode throughput (oracle, -O2): run_length_decode ->
    # dequantize -> dct_inverse, timed inside the C call (encode untimed)
    from dct_tpu import oracle

    if oracle.available():
        rng = np.random.default_rng(0)
        px = rng.integers(0, 256, (20000, 8, 8)).astype(np.uint8)
        oracle.decode_batch_seconds(px[:500], args.quality)  # warmup
        dt_o = oracle.decode_batch_seconds(px, args.quality)
        print(
            f"C reference      : {dt_o*1e3:9.2f} ms  "
            f"{px.shape[0]*64/dt_o/1e6:9.1f} Mpix/s (decode half, -O2)"
        )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
