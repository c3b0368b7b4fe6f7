#!/usr/bin/env python
"""Sharded-encode scaling: Mpix/s at 1, 2, 4, 8 devices (BASELINE.json
configs 4-5 shape: one large image striped across chips).

By default this runs against 8 virtual CPU devices, which validates
sharding/collective structure and measures scaling SHAPE (CPU numbers are
not device numbers). With --backend native on a multi-GPU host the same
script, in one process, reports true Mpix/s scaling.

Also asserts the determinism contract: every mesh shape yields the
byte-identical container.
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
    ap.add_argument("--size", default="3840x2160")  # 4K
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--quality", type=int, default=50)
    ap.add_argument(
        "--backend", choices=("cpu", "native"), default="cpu",
        help="cpu (default): force an 8-virtual-device CPU mesh — scaling "
        "SHAPE needs multiple devices; native: use whatever backend jax "
        "picks (e.g. a multi-GPU host)",
    )
    args = ap.parse_args()

    import os

    if args.backend == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()

    import jax

    if args.backend == "cpu":
        # authoritative over any JAX_PLATFORMS in the environment
        jax.config.update("jax_platforms", "cpu")

    from dct_tpu.config import CodecConfig
    from dct_tpu.parallel import mesh as meshlib
    from dct_tpu.parallel import shard_encode
    from dct_tpu.utils import image_io

    w, h = (int(x) for x in args.size.split("x"))
    img = image_io.synthetic_image(h, w, "photo", seed=0)
    cfg = CodecConfig(quality=args.quality)

    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    print(f"backend={jax.default_backend()} devices={n_dev} image={w}x{h}")

    ref_bytes = None
    base = None
    for n in sizes:
        mesh = meshlib.make_mesh(n_data=1, n_stripe=n, devices=jax.devices()[:n])
        out = shard_encode.encode_image_sharded(img, cfg, mesh)  # warm
        if ref_bytes is None:
            ref_bytes = out
        assert out == ref_bytes, f"mesh {n}: bitstream differs!"
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = shard_encode.encode_image_sharded(img, cfg, mesh)
        dt = (time.perf_counter() - t0) / args.iters
        mpix = img.size / dt / 1e6
        if base is None:
            base = mpix
        eff = mpix / (base * n) * 100
        print(f"devices={n:>2}: {dt*1e3:8.1f} ms  {mpix:8.2f} Mpix/s  "
              f"scaling efficiency {eff:5.1f}%")
    print("bitstreams byte-identical across all mesh shapes: OK")
    if args.backend == "cpu":
        print(
            "NOTE: virtual CPU devices share the host's physical cores, so "
            "the efficiency column cannot show real speedup here — it "
            "validates sharding/collective STRUCTURE and determinism. Run "
            "with --backend native on a multi-GPU host for true "
            "Mpix/s scaling."
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
