#!/usr/bin/env python
"""Smoke test of the codec's main paths on one GPU, at real sizes.

    python chip_smoke.py               # one GPU: every single-card phase
    python chip_smoke.py --devices 4   # four GPUs: the sharded phases only

Phases (inputs are seeded image_io.synthetic_image "photo" frames):

  gray_batch  8 x 1088x1920 gray: ImageCodec encode / decode /
              decode_to_device at q50 static tables (encode_step, one
              dispatch) and q90 per-image tables (encode_analyze -> host
              table -> encode_pack)
  color_still 3840x2160 RGB 4:2:0, coded runs + DC prediction, through
              codec.encode / codec.decode (BASELINE.json config 3)
  video       16 x 1080p through VideoCodec.encode / decode_to_device
  rate        one 1080p frame through rate_control.encode_to_size
  cli         encode / info / verify / decode via dct_tpu.cli.main,
              in this process (a second JAX process could not get the card)
  sharded     (--devices 4) 7680x4320 gray and RGB 4:2:0 encodes on 1x4
              and 2x2 meshes, the dp x sp batch step on 4 x 1080p, sharded
              device decode and the sharded encode_to_size

Every phase checks, and stops the run on the first failure:
  (a) parity: quantized coefficients against a float64 numpy reference
      built from tables.py's operators — mismatches only at exact .5 ties,
      each off by at most 1, under 1% of coefficients (the contract of
      tests/test_parity.py);
  (b) each GPU container equals the same encode on the CPU backend in this
      process, byte for byte (sharded phase: the single-GPU encode);
  (c) the host C++ decoder, the Python decoder and the device (lax)
      entropy decoder give identical pixels;
  (d) PSNR.

Each phase prints its wall time, and for its main calls the first-call
time (compilation included) beside the warm time: compilation is about
their difference. Exits non-zero, printing no result, when JAX finds no
GPU. The last line is the JSON the harness reads:
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def check(cond, msg: str) -> None:
    """A failed check ends the run (no phase continues past one)."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    """(result, seconds) of one call that ends with the device idle."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def first_and_warm(fn):
    """(result, first-call seconds incl. compile, warm-call seconds)."""
    _, t_first = timed(fn)
    out, t_warm = timed(fn)
    return out, t_first, t_warm


def photo(h: int, w: int, seed: int) -> np.ndarray:
    from dct_tpu.utils import image_io

    return np.asarray(image_io.synthetic_image(h, w, "photo", seed=seed))


def photo_rgb(h: int, w: int, seed: int) -> np.ndarray:
    g = photo(h, w, seed)
    return np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)], axis=-1)


def on_cpu(fn):
    """fn() with the CPU backend as the default device."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return fn()


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------


def parity_f64(frames: np.ndarray, cfg, chroma: bool = False) -> dict:
    """(a): device-quantized coefficients vs a float64 numpy reference of
    the same operator (level shift, 2D DCT, zigzag, quant divide; round
    half away from zero). Non-adaptive configs."""
    import jax
    import jax.numpy as jnp

    from dct_tpu import tables
    from dct_tpu.models import codec
    from dct_tpu.ops import blocks as blk
    from dct_tpu.ops import transform

    n = cfg.block_size
    perm = tables.zigzag_permutation(n)
    kp = tables._kron_dct(n)[perm, :] / tables._zigzag_quant(cfg, chroma)[:, None]
    quantize = jax.jit(
        lambda im: transform.encode_blocks(
            blk.image_to_blocks(im, n), cfg, chroma=chroma
        )
    )
    n_coef = n_tie = n_bad = 0
    where = np.zeros(cfg.n2, np.int64)
    for f in frames:
        img = codec.pad_plane_for_encode(f, cfg)
        got = np.asarray(quantize(img))
        px = np.asarray(blk.image_to_blocks(jnp.asarray(img), n), np.float64)
        y = (px - 128.0) @ kp.T
        want = np.trunc(y + np.where(y >= 0, 0.5, -0.5))
        mism = got != want
        ties = np.abs(np.abs(y) % 1.0 - 0.5) < 1e-6
        n_coef += got.size
        n_tie += int((mism & ties).sum())
        n_bad += int((mism & (~ties | (np.abs(got - want) > 1))).sum())
        where += mism.sum(axis=0)
    rate = n_tie / n_coef
    check(n_bad == 0, f"{n_bad} non-tie coefficient mismatches vs float64")
    check(rate < 0.01, f"tie mismatch rate {rate:.2e} >= 1%")
    out = {"coefficients": n_coef, "tie_mismatches": n_tie,
           "c_oracle": _c_oracle_parity(got, px, y, cfg, chroma)}
    if n_tie:
        out["mismatch_zigzag_index"] = {
            int(k): int(where[k]) for k in np.nonzero(where)[0]
        }
    return out


def _c_oracle_parity(got, px, y, cfg, chroma, n_blocks: int = 2048):
    """The unmodified C reference (dct_tpu.oracle, linked from outside the
    repository) on the last frame's first blocks, under the same tie rule;
    "not available" where the reference sources are absent."""
    from dct_tpu import oracle, tables

    if cfg.block_size != 8 or chroma or cfg.adaptive or not oracle.available():
        return "not available"
    perm = tables.zigzag_permutation(8)
    bad = 0
    for b in range(min(n_blocks, len(px))):
        want = oracle.quantize(
            oracle.dct_forward(px[b].reshape(8, 8) - 128.0), cfg.quality
        ).ravel()[perm]
        mism = got[b] != want
        tie = np.abs(np.abs(y[b]) % 1.0 - 0.5) < 1e-6
        bad += int((mism & (~tie | (np.abs(got[b] - want) > 1))).sum())
    check(bad == 0, f"{bad} non-tie coefficient mismatches vs the C oracle")
    return f"{min(n_blocks, len(px))} blocks agree up to ties"


def coeff_diff(frame: np.ndarray, cfg) -> int:
    """Quantized coefficients of one frame that differ between the
    default device and the CPU backend (diagnosis of a (b) failure)."""
    import jax

    from dct_tpu.models import codec
    from dct_tpu.ops import blocks as blk
    from dct_tpu.ops import transform

    fn = jax.jit(lambda im: transform.encode_blocks(
        blk.image_to_blocks(im, cfg.block_size), cfg
    ))
    img = np.asarray(codec.pad_plane_for_encode(frame, cfg))
    dev = np.asarray(fn(img))
    cpu = np.asarray(on_cpu(lambda: fn(img)))
    return int((dev != cpu).sum())


def python_decode(data: bytes) -> np.ndarray:
    """Decode with the pure-Python entropy decoder
    (bitstream.unpack_stripe_host) and the shared device reconstruct."""
    import jax.numpy as jnp

    from dct_tpu import container as cont
    from dct_tpu.models import codec, color
    from dct_tpu.ops import bitstream as bs

    c = cont.deserialize(data)
    cfg = c.config
    planes = []
    for i, p in enumerate(c.planes):
        bh, bw, n_stripes = codec._padded_grid(p.height, p.width, cfg)
        bps = (bh // n_stripes) * bw
        mode, table, run_table = codec._plane_tables(p, cfg)
        zz = np.concatenate([
            bs.unpack_stripe_host(
                s, bps, cfg.n2, mode,
                cat_table=table if mode == "category" else None,
                val_table=table if mode == "direct" else None,
                vmin=codec.DIRECT_VMIN, run_table=run_table,
            )
            for s in p.stripes
        ])
        vc = jnp.asarray(p.variance_codes) if cfg.adaptive else None
        img = codec._reconstruct(
            jnp.asarray(zz), vc, cfg, i > 0, n_stripes, bh, bw
        )
        planes.append(img[: p.height, : p.width])
    if cfg.chroma == "gray":
        return np.asarray(planes[0])
    return np.asarray(
        color.planes_to_rgb(*planes, cfg.chroma, c.height, c.width)
    )


def decoders_agree(datas: list[bytes], python_frames: int = 1) -> list:
    """(c): host C++ decode (codec.decode), device decode
    (decode_to_device; the lax entropy decoder for indexed containers)
    and, for the first python_frames containers, the Python decoder give
    identical pixels. Returns the host-decoded images."""
    from dct_tpu import container as cont
    from dct_tpu.models import codec
    from dct_tpu.models.color import ColorImageCodec

    out = []
    for k, d in enumerate(datas):
        cfg = cont.deserialize(d).config
        host = codec.decode(d)
        if cfg.chroma == "gray":
            dev = codec.ImageCodec(cfg).decode_to_device(d)
        else:
            dev = ColorImageCodec(cfg).decode_to_device(d)
        check(np.array_equal(np.asarray(dev), host),
              f"container {k}: device decode != host C++ decode")
        if k < python_frames:
            check(np.array_equal(python_decode(d), host),
                  f"container {k}: Python decode != host C++ decode")
        out.append(host)
    return out


CHECKS = ("float64 parity (ties only); gpu==cpu bytes; host C++ == "
          "device == Python (first container) pixels")


def mean_psnr(refs, recs) -> float:
    from dct_tpu.utils import metrics

    return float(np.mean([metrics.psnr(a, b) for a, b in zip(refs, recs)]))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_gray_batch(n_frames: int, h: int, w: int) -> dict:
    """ImageCodec encode/decode/decode_to_device, q50 static tables and
    q90 per-image tables, decode index on (so decode_to_device runs the
    device entropy decoder)."""
    from dct_tpu.config import CodecConfig
    from dct_tpu.models import codec

    frames = np.stack([photo(h, w, s) for s in range(n_frames)])
    out = {}
    for name, cfg in (
        ("q50_static", CodecConfig(quality=50, static_tables=True,
                                   decode_index=True)),
        ("q90_dynamic", CodecConfig(quality=90, decode_index=True)),
    ):
        ic = codec.ImageCodec(cfg)
        parity = parity_f64(frames, cfg)
        datas, t_first, t_warm = first_and_warm(
            lambda: [ic.encode(f) for f in frames]
        )
        cpu = on_cpu(lambda: [ic.encode(f) for f in frames])
        if datas != cpu:
            k = next(i for i in range(n_frames) if datas[i] != cpu[i])
            check(False, f"{name}: GPU container {k} != CPU container; "
                  f"{coeff_diff(frames[k], cfg)} quantized coefficients "
                  f"differ between the backends")
        recs = decoders_agree(datas)
        _, d_first, d_warm = first_and_warm(
            lambda: [ic.decode_to_device(d) for d in datas]
        )
        out[name] = {
            "checks": CHECKS,
            "bytes": sum(len(d) for d in datas),
            "encode_first_s": round(t_first, 3),
            "encode_warm_s": round(t_warm, 3),
            "decode_to_device_first_s": round(d_first, 3),
            "decode_to_device_warm_s": round(d_warm, 3),
            "psnr_db": round(mean_psnr(frames, recs), 3),
            "parity": parity,
        }
    return out


def phase_color_still(h: int, w: int) -> dict:
    from dct_tpu.config import CodecConfig
    from dct_tpu.models import codec

    rgb = photo_rgb(h, w, 21)
    cfg = CodecConfig(
        quality=75, chroma="420", coded_runs=True, dc_prediction=True,
        decode_index=True,
    )
    data, t_first, t_warm = first_and_warm(lambda: codec.encode(rgb, cfg))
    if data != on_cpu(lambda: codec.encode(rgb, cfg)):
        def planes():
            return [np.asarray(p) for p in _planes(rgb)]

        diff = [int((a != b).sum()) for a, b in zip(planes(), on_cpu(planes))]
        check(False, f"color: GPU container != CPU container; Y/Cb/Cr "
              f"pixels differing between the backends: {diff}")
    (rec,) = decoders_agree([data])
    _, d_first, d_warm = first_and_warm(lambda: codec.decode(data))
    return {
        "checks": CHECKS,
        "bytes": len(data),
        "encode_first_s": round(t_first, 3),
        "encode_warm_s": round(t_warm, 3),
        "decode_first_s": round(d_first, 3),
        "decode_warm_s": round(d_warm, 3),
        "psnr_db": round(mean_psnr([rgb], [rec]), 3),
        "parity_luma": parity_f64(
            np.asarray(_planes(rgb)[0])[None], cfg.replace(chroma="gray")
        ),
    }


def _planes(rgb: np.ndarray):
    """The 4:2:0 (Y, Cb, Cr) planes the encoder codes, on the default
    device."""
    import jax.numpy as jnp

    from dct_tpu.models import color

    return color._to_planes(jnp.asarray(rgb), "420")


def phase_video(n_frames: int, h: int, w: int) -> dict:
    from dct_tpu.config import CodecConfig
    from dct_tpu.models import codec
    from dct_tpu.models.video import VideoCodec

    frames = np.stack([photo(h, w, 100 + s) for s in range(n_frames)])
    cfg = CodecConfig(quality=75, decode_index=True)
    vc = VideoCodec(cfg)
    streams, t_first, t_warm = first_and_warm(lambda: vc.encode(frames))
    check(streams == on_cpu(lambda: vc.encode(frames)),
          "video: GPU containers != CPU containers")
    dev, d_first, d_warm = first_and_warm(lambda: vc.decode_to_device(streams))
    host = np.stack([codec.decode(s) for s in streams])
    check(np.array_equal(np.asarray(dev), host),
          "video: batched device decode != host C++ decode")
    check(np.array_equal(python_decode(streams[0]), host[0]),
          "video: Python decode != host C++ decode")
    return {
        "checks": "gpu==cpu bytes; batched device decode == host C++ == "
                  "Python (frame 0) pixels",
        "bytes": sum(len(s) for s in streams),
        "encode_first_s": round(t_first, 3),
        "encode_warm_s": round(t_warm, 3),
        "decode_to_device_first_s": round(d_first, 3),
        "decode_to_device_warm_s": round(d_warm, 3),
        "psnr_db": round(mean_psnr(frames, host), 3),
    }


def phase_rate(h: int, w: int) -> dict:
    from dct_tpu.config import CodecConfig
    from dct_tpu.models import rate_control

    img = photo(h, w, 7)
    cfg = CodecConfig(coded_runs=True, decode_index=True)
    budget = img.size // 10  # 0.8 bits per pixel
    (data, q), t_first, t_warm = first_and_warm(
        lambda: rate_control.encode_to_size(img, budget, cfg)
    )
    check(len(data) <= budget, f"rate: {len(data)} B > budget {budget}")
    cpu_data, cpu_q = on_cpu(
        lambda: rate_control.encode_to_size(img, budget, cfg)
    )
    check((data, q) == (cpu_data, cpu_q), "rate: GPU result != CPU result")
    (rec,) = decoders_agree([data], python_frames=0)
    return {
        "checks": "gpu==cpu bytes and quality; within budget; device "
                  "decode == host C++ pixels",
        "budget": budget,
        "bytes": len(data),
        "quality": q,
        "first_s": round(t_first, 3),
        "warm_s": round(t_warm, 3),
        "psnr_db": round(mean_psnr([img], [rec]), 3),
    }


def phase_cli(h: int, w: int, workdir: pathlib.Path) -> dict:
    from dct_tpu import cli
    from dct_tpu.models import codec
    from dct_tpu.utils import image_io

    workdir.mkdir(parents=True, exist_ok=True)
    img = photo(h, w, 3)
    src, enc, rec = (workdir / n for n in ("in.pgm", "out.tpdc", "rec.pgm"))
    image_io.write_image(src, img)
    t0 = time.perf_counter()
    for argv in (
        ["encode", str(src), str(enc), "--quality", "80", "--coded-runs",
         "--dc-prediction", "--decode-index", "on"],
        ["info", str(enc)],
        ["verify", str(enc)],
        ["decode", str(enc), str(rec)],
    ):
        rc = cli.main(argv)
        check(rc == 0, f"cli {argv[0]} returned {rc}")
    data = enc.read_bytes()
    got = image_io.read_image(rec)
    check(np.array_equal(got, codec.decode(data)),
          "cli: decoded file != codec.decode of the container")
    decoders_agree([data], python_frames=0)
    return {
        "checks": "cli rc 0; cli decode == codec.decode == device decode",
        "bytes": len(data),
        "wall_s": round(time.perf_counter() - t0, 3),
        "psnr_db": round(mean_psnr([img], [got]), 3),
    }


def phase_sharded(h: int, w: int, batch_h: int, batch_w: int,
                  devices: list) -> dict:
    """Sharded paths on 4 devices, each compared byte for byte with the
    single-device encode on devices[0] and with the host decode."""
    import jax
    import jax.numpy as jnp

    from dct_tpu.config import CodecConfig
    from dct_tpu.models import codec, rate_control
    from dct_tpu.ops import bitstream as bs
    from dct_tpu.parallel import mesh as meshlib
    from dct_tpu.parallel import shard_encode

    check(len(devices) == 4, f"sharded phase needs 4 devices, got {len(devices)}")
    meshes = {
        "1x4": meshlib.make_mesh(n_data=1, n_stripe=4, devices=devices),
        "2x2": meshlib.make_mesh(n_data=2, n_stripe=2, devices=devices),
    }
    out = {}
    with jax.default_device(devices[0]):
        for name, image, cfg in (
            ("gray_q50_dynamic", photo(h, w, 41),
             CodecConfig(quality=50, decode_index=True)),
            ("rgb420_coded_runs", photo_rgb(h, w, 42),
             CodecConfig(quality=50, chroma="420", coded_runs=True,
                         decode_index=True)),
        ):
            single = codec.encode(image, cfg)
            host = codec.decode(single)
            res = {"bytes": len(single)}
            for mname, mesh in meshes.items():
                data, t_first, t_warm = first_and_warm(
                    lambda: shard_encode.encode_image_sharded(image, cfg, mesh)
                )
                check(data == single,
                      f"{name} {mname}: sharded bytes != single-device bytes")
                rec = shard_encode.decode_image_sharded(data, mesh)
                n_dev = len(rec.sharding.device_set)
                check(n_dev >= mesh.shape["stripe"],
                      f"{name} {mname}: decode spread over {n_dev} devices")
                check(np.array_equal(np.asarray(rec), host),
                      f"{name} {mname}: sharded decode != host decode")
                res[mname] = {
                    "encode_first_s": round(t_first, 3),
                    "encode_warm_s": round(t_warm, 3),
                }
            res["psnr_db"] = round(mean_psnr([image], [host]), 3)
            res["checks"] = ("sharded bytes == single-GPU bytes on both "
                             "meshes; sharded device decode == host decode")
            out[name] = res

        cfg = CodecConfig(quality=50, static_tables=True)
        frames = np.stack([photo(batch_h, batch_w, 50 + s) for s in range(4)])
        n_stripes = -(-batch_h // 8)
        packed, t_first, t_warm = first_and_warm(
            lambda: shard_encode.encode_batch_step(
                jnp.asarray(frames), cfg, n_stripes, meshes["2x2"]
            )
        )
        check(len(packed.units.sharding.device_set) == 4,
              "batch step output not spread over 4 devices")
        for f in range(4):
            single = codec.encode_step(jnp.asarray(frames[f]), cfg, n_stripes)[0]
            got = bs.stripes_to_bytes(bs.PackedStripes(
                np.asarray(packed.units[f]), np.asarray(packed.bit_lengths[f])
            ))
            check(got == bs.stripes_to_bytes(single),
                  f"batch step frame {f} != single-device encode_step")
        out["batch_step_2x2"] = {
            "first_s": round(t_first, 3), "warm_s": round(t_warm, 3),
        }

        img = photo(h, w, 43)
        cfg = CodecConfig(coded_runs=True)
        budget = img.size // 10
        want = rate_control.encode_to_size(img, budget, cfg)
        (data, q), t_first, t_warm = first_and_warm(
            lambda: rate_control.encode_to_size(
                img, budget, cfg, mesh=meshes["1x4"]
            )
        )
        check((data, q) == want, "sharded encode_to_size != single-device")
        check(len(data) <= budget, "sharded encode_to_size over budget")
        out["rate_1x4"] = {
            "quality": q, "bytes": len(data),
            "first_s": round(t_first, 3), "warm_s": round(t_warm, 3),
        }
    return out


# ---------------------------------------------------------------------------


def _run_phase(name: str, fn, *args) -> dict:
    t0 = time.perf_counter()
    res = fn(*args)
    log(f"phase {name}: wall {time.perf_counter() - t0:.3f} s "
        f"{json.dumps(res, sort_keys=True)}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded phases, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform})",
              file=sys.stderr)
        return 1
    if len(devices) < args.devices:
        print(f"chip_smoke: --devices {args.devices} but JAX sees "
              f"{len(devices)}", file=sys.stderr)
        return 1

    from dct_tpu import native
    from dct_tpu.utils import compile_cache

    cache_dir = compile_cache.configure()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {cache_dir}")
    log(f"native C++ decoder built: {native.available()}")
    check(native.available(), "native C++ decoder did not build")

    if args.devices == 4:
        _run_phase("sharded", phase_sharded, 4320, 7680, 1088, 1920,
                   devices[:4])
    else:
        _run_phase("gray_batch", phase_gray_batch, 8, 1088, 1920)
        _run_phase("color_still", phase_color_still, 2160, 3840)
        _run_phase("video", phase_video, 16, 1080, 1920)
        _run_phase("rate", phase_rate, 1080, 1920)
        _run_phase("cli", phase_cli, 1080, 1920, REPO / "build" / "chip_smoke")

    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
