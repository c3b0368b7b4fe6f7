"""Metrics: the reference's metric vocabulary (MSE, PSNR, RLE ratio,
bit-size, compression ratio — SURVEY.md section 5.5) plus throughput.

Reference formulas being matched:
  * MSE over a block — test_dct.c:12-23
  * PSNR = 10*log10(255^2 / MSE) — test_entropy.c:389-392
  * RLE ratio = N^2 / symbol_count — test_entropy.c:334-335
  * compression ratio = raw_bits / encoded_bits — test_entropy.c:344-346
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import numpy as np


def mse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def psnr(a, b, peak: float = 255.0) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))


def rle_ratio(n2: int, symbol_count: int) -> float:
    return n2 / max(symbol_count, 1)


def compression_ratio(raw_bytes: int, encoded_bytes: int) -> float:
    return raw_bytes / max(encoded_bytes, 1)


@dataclass
class Throughput:
    mpix_per_s: float
    seconds_per_frame: float
    pixels: int
    iters: int


def measure_throughput(fn, *args, iters: int = 20, warmup: int = 3,
                       pixels: int = 0) -> Throughput:
    """Time a device function with proper jax synchronization.

    fn(*args) must return jax arrays (or pytrees of them); timing brackets
    block_until_ready, the standard JAX benchmarking harness (SURVEY.md
    section 5.1).
    """
    for _ in range(warmup):
        out = fn(*args)
        jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return Throughput(
        mpix_per_s=pixels / dt / 1e6 if pixels else 0.0,
        seconds_per_frame=dt,
        pixels=pixels,
        iters=iters,
    )


def kloop_delta_seconds(make_step, operand, k: int = 9, iters: int = 5):
    """Dispatch-corrected device timing: seconds per body execution.

    ``make_step(k)`` must return a jitted fn running its body k times in a
    lax.fori_loop (each trip on DISTINCT data so XLA cannot collapse the
    bodies) and returning a scalar. Times trip counts 1 and k; the delta
    cancels the fixed per-dispatch cost. Returns (seconds_per_body,
    noise_dominated):
    if the delta is non-positive the single-dispatch time is returned with
    the flag set — callers should report, not hide, that condition.
    """
    import time as _time

    r1, rk = make_step(1), make_step(k)

    def timed(fn):
        float(fn(operand))  # compile + warmup; scalar fetch = device sync
        t0 = _time.perf_counter()
        for _ in range(iters):
            float(fn(operand))
        return (_time.perf_counter() - t0) / iters

    t1, tk = timed(r1), timed(rk)
    if tk <= t1:
        return t1, True
    return (tk - t1) / (k - 1), False
