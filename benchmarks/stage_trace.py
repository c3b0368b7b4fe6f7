#!/usr/bin/env python
"""Per-stage device time of the gray 1080p batch, from a jax.profiler trace.

Workload: 8 x 1088x1920 "photo" frames (bench.py's), q50 static tables.
Each pipeline stage runs as its own jitted function, so the trace's
device events group by XLA module name:

  encode  transform        image_to_blocks + DCT/quant/zigzag matmul
          symbolize        positional RLE + symbol_chunks (chunk values
                           and lengths)
          pack             pack_chunks (offset scans + scatter-add)
          encode_step      the production single dispatch, all of the above
  decode  dequant_idct     dequant + IDCT + image assembly
          lax_entropy_q*   the device entropy decoder, one frame

Host-side work is timed on the host clock: D2H + container assembly
(fetch_packed, stripes_to_bytes, serialize), the host C++ entropy
decode and the int16 coefficient upload, per frame. The lax-vs-host
decode comparison runs at q50 and q90.

Requires a GPU (exits non-zero otherwise). Usage:

    python benchmarks/stage_trace.py [--out build/stage_trace]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)

import argparse
import collections
import glob
import json
import subprocess
import time

import numpy as np


def device_time_by_module(trace_dir: str) -> dict:
    """Sum of device event durations (ms) per XLA module, plus memcpy
    events by name, from the newest .xplane.pb under trace_dir."""
    import jax

    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    by_mod: dict[str, float] = collections.defaultdict(float)
    sample = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if len(sample) < 4:
                    sample.append(f"{plane.name}|{line.name}|{ev.name}|"
                                  f"{sorted(stats)}")
                key = stats.get("hlo_module")
                if key is None:
                    key = "memcpy:" + ev.name if "emcpy" in ev.name else None
                if key is None:
                    continue
                by_mod[str(key)] += ev.duration_ns / 1e6
    out = {k: round(v, 4) for k, v in sorted(by_mod.items())}
    out["sample_events"] = sample
    return out


def run(n_frames: int, h: int, w: int, trace_dir: str, reps: int = 3) -> dict:
    import jax
    import jax.numpy as jnp

    from dct_tpu import container as cont
    from dct_tpu.config import CodecConfig
    from dct_tpu.models import codec
    from dct_tpu.ops import bitstream as bs
    from dct_tpu.ops import blocks as blk
    from dct_tpu.ops import entropy_decode as ed
    from dct_tpu.ops import huffman as hf
    from dct_tpu.ops import rle, transform
    from dct_tpu.utils import image_io

    cfg = CodecConfig(quality=50, static_tables=True)
    n_stripes = h // 8
    frames = jnp.asarray(np.stack([
        image_io.synthetic_image(h, w, "photo", seed=s) for s in range(n_frames)
    ]))
    lengths, codes = codec._table_arrays(hf.default_category_table(50))
    cap = (w // 8) * bs.units_per_block_worst(64)

    @jax.jit
    def transform_stage(fr):
        return jax.vmap(
            lambda im: transform.encode_blocks(blk.image_to_blocks(im, 8), cfg)
        )(fr)

    @jax.jit
    def symbolize_stage(zz):
        def one(z):
            cv, cl = codec.symbol_chunks_for(
                rle.rle_encode_positional(z), cfg, lengths, codes
            )
            return (cv.reshape(n_stripes, -1, 3), cl.reshape(n_stripes, -1, 3))
        return jax.vmap(one)(zz)

    @jax.jit
    def pack_stage(cv, cl):
        return jax.vmap(lambda v, l: bs.pack_chunks(v, l, cap))(cv, cl)

    @jax.jit
    def encode_step_stage(fr):
        return jax.vmap(lambda im: codec.encode_step(im, cfg, n_stripes))(fr)

    @jax.jit
    def dequant_idct_stage(zz):
        return jax.vmap(lambda z: codec._reconstruct(
            z, None, cfg, False, n_stripes, h // 8, w // 8
        ))(zz)

    zz = transform_stage(frames)
    cv, cl = symbolize_stage(zz)
    stages = [
        ("transform", lambda: transform_stage(frames)),
        ("symbolize", lambda: symbolize_stage(zz)),
        ("pack", lambda: pack_stage(cv, cl)),
        ("encode_step", lambda: encode_step_stage(frames)),
        ("dequant_idct", lambda: dequant_idct_stage(zz)),
    ]

    # decode routes per 1080p frame, q50 and q90: lax (device) entropy
    # decode vs host C++ entropy decode + int16 upload
    routes = {}
    lax_calls = []
    for q in (50, 90):
        c = CodecConfig(quality=q, decode_index=True)
        data = codec.encode(np.asarray(frames[0]), c)
        p = cont.deserialize(data).planes[0]
        mode, table, run_table = codec._plane_tables(p, c)
        arrays = tuple(
            jnp.asarray(a)
            for a in codec._device_decode_prep([p], table, mode, run_table)
        )
        def lax_entropy(*a, c=c):
            return ed.decode_blocks(*a, **codec._entropy_statics(c))

        lax_entropy.__name__ = lax_entropy.__qualname__ = f"lax_entropy_q{q}"
        lax_fn = jax.jit(lax_entropy)
        bh, bw, ns = codec._padded_grid(p.height, p.width, c)
        host_zz = codec._decode_stripes(
            p, c, table, mode, ns, (bh // ns) * bw, run_table
        )
        check = np.asarray(lax_fn(*arrays))
        if not np.array_equal(check, host_zz):
            raise AssertionError(f"q{q}: lax entropy decode != host decode")
        t_host = _best(lambda: codec._decode_stripes(
            p, c, table, mode, ns, (bh // ns) * bw, run_table
        ))
        t_upload = _best(lambda: jax.block_until_ready(jnp.asarray(host_zz)))
        t_lax = _best(lambda: jax.block_until_ready(lax_fn(*arrays)))
        routes[f"q{q}"] = {
            "bytes": len(data),
            "host_cpp_entropy_ms": round(t_host * 1e3, 3),
            "upload_int16_ms_wall": round(t_upload * 1e3, 3),
            "lax_entropy_ms_wall": round(t_lax * 1e3, 3),
        }
        lax_calls.append((f"lax_entropy_q{q}", lambda f=lax_fn, a=arrays: f(*a)))

    # D2H + container assembly, host clock, per frame
    packed = encode_step_stage(frames)[0]
    jax.block_until_ready(packed)

    def assemble():
        for i in range(n_frames):
            pk = bs.fetch_packed(bs.PackedStripes(
                packed.units[i], packed.bit_lengths[i]
            ))
            cont.serialize(cont.Container(
                config=cfg, width=w, height=h, planes=[cont.PlaneData(
                    width=w, height=h,
                    table_lengths=hf.default_category_table(50).lengths,
                    vmin=codec.DIRECT_VMIN, variance_codes=None,
                    stripe_bits=pk.bit_lengths.astype(np.uint32),
                    stripes=bs.stripes_to_bytes(pk),
                )],
            ))

    t_asm = _best(assemble) / n_frames

    for _, fn in stages + lax_calls:
        jax.block_until_ready(fn())  # compile outside the trace
    with jax.profiler.trace(trace_dir):
        for name, fn in stages + lax_calls:
            with jax.profiler.TraceAnnotation(name):
                for _ in range(reps):
                    jax.block_until_ready(fn())
    dev = device_time_by_module(trace_dir)
    return {
        "frames": n_frames,
        "size": f"{w}x{h}",
        "reps": reps,
        "device_ms_by_module_total": dev,
        "d2h_assembly_ms_per_frame_host": round(t_asm * 1e3, 3),
        "decode_routes_per_frame": routes,
    }


def _best(fn, iters: int = 5) -> float:
    fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/stage_trace",
                    help="directory for the profiler trace")
    args = ap.parse_args()

    import jax

    from dct_tpu.utils import compile_cache

    compile_cache.configure()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"stage_trace needs a GPU; JAX found {dev.platform}",
              file=_sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    res = run(8, 1088, 1920, args.out)
    res["card"] = smi
    res["device_kind"] = dev.device_kind
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    _sys.exit(main())
