"""Run-length encoding of zigzag coefficient streams — vectorized, no loops.

Reference semantics (entropy.c:216-256, run_length_encode):
  * walk the zigzag stream; at each nonzero value emit ``(value, run)`` where
    ``run`` = number of zeros since the previous emitted symbol;
  * if the LAST position is zero, emit one terminal symbol
    ``(0, trailing_zero_count + 1)`` — the +1 comes from entropy.c:231-233
    incrementing zero_count before emitting. An all-zero block therefore
    yields exactly one symbol ``(0, N^2)``.
  * decode (entropy.c:333-358): pos += run; if pos < N^2 write value at pos,
    pos += 1. After a block's symbols, pos always lands exactly at N^2, so a
    bitstream decoder needs no per-block symbol count.

Data-parallel formulation (SURVEY.md section 7 "hard parts" #1): everything is
a prefix-sum over the length-N^2 axis, batched over blocks:

  * ``pnz[i]`` — index of the previous nonzero — is an exclusive cumulative
    max of ``where(mask, iota, -1)``;
  * ``run[i] = i - pnz[i] - 1`` (+1 at the terminal-zero position);
  * output slot = inclusive cumsum of the symbol indicator, minus 1;
  * compaction to the front of a fixed (B, N^2) symbol buffer is a stable
    argsort on the indicator (static shapes; no data-dependent control flow).

Outputs keep the worst-case static shape (N^2 symbols per block) plus a
per-block count — the fixed-shape idiom the rest of the entropy stage
(histograms, bit packing) consumes directly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class RLEBlocks(NamedTuple):
    """Fixed-shape RLE symbol arrays for a batch of blocks.

    values: (B, N^2) int32 — symbol values, zero-padded past ``counts``.
    runs:   (B, N^2) int32 — zero-run preceding each value (entropy.h:35-38).
    counts: (B,)     int32 — symbols actually present per block.
    """

    values: jax.Array
    runs: jax.Array
    counts: jax.Array


class RLEPositional(NamedTuple):
    """Uncompacted RLE symbols, one slot per zigzag POSITION.

    The production encode path never compacts: zero-length chunks advance
    neither bit offsets nor histograms, so the stable-sort compaction in
    :func:`rle_encode` (needed only for the symbol-array API and reference
    parity tests) is pure overhead on the hot path.

    values: (B, N^2) int32 — symbol value at emitting positions, else 0.
    runs:   (B, N^2) int32 — zero-run before the value, else 0.
    is_sym: (B, N^2) bool  — True where a symbol is emitted.
    """

    values: jax.Array
    runs: jax.Array
    is_sym: jax.Array

    @property
    def counts(self) -> jax.Array:
        return jnp.sum(self.is_sym, axis=1).astype(jnp.int32)


def rle_encode_positional(zz: jax.Array) -> RLEPositional:
    """Zigzag coefficients (B, N^2) -> positional RLE symbols.

    Two prefix scans, no sort, no gather — the hot-path encoder.
    """
    B, n2 = zz.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (B, n2), dimension=1)
    mask = zz != 0
    marked = jnp.where(mask, idx, -1)
    pnz_incl = jax.lax.cummax(marked, axis=1)
    pnz = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), pnz_incl[:, :-1]], axis=1
    )
    is_last = idx == (n2 - 1)
    is_sym = mask | is_last
    terminal_zero = is_last & ~mask
    run = idx - pnz - 1 + terminal_zero.astype(jnp.int32)
    return RLEPositional(
        values=jnp.where(is_sym, zz, 0).astype(jnp.int32),
        runs=jnp.where(is_sym, run, 0).astype(jnp.int32),
        is_sym=is_sym,
    )


def compact(symbols: RLEPositional) -> RLEBlocks:
    """Positional -> front-compacted symbol arrays (stable sort on the
    indicator). Used by the symbol-level API and parity tests."""
    values, runs, is_sym = symbols.values, symbols.runs, symbols.is_sym
    B, n2 = values.shape
    counts = symbols.counts
    order = jnp.argsort(jnp.logical_not(is_sym), axis=1, stable=True)
    v = jnp.take_along_axis(values, order, axis=1)
    r = jnp.take_along_axis(runs, order, axis=1)
    slot = jax.lax.broadcasted_iota(jnp.int32, (B, n2), dimension=1)
    live = slot < counts[:, None]
    return RLEBlocks(
        values=jnp.where(live, v, 0).astype(jnp.int32),
        runs=jnp.where(live, r, 0).astype(jnp.int32),
        counts=counts,
    )


def rle_encode(zz: jax.Array) -> RLEBlocks:
    """Zigzag coefficients (B, N^2) int -> RLE symbols, reference-exact.

    Fully parallel: two prefix scans + one stable sort along the N^2 axis.
    """
    return compact(rle_encode_positional(zz))


def rle_decode(symbols: RLEBlocks, n2: int) -> jax.Array:
    """RLE symbols -> zigzag coefficients (B, N^2) int32.

    Mirrors run_length_decode (entropy.c:333-358): write position of symbol s
    is ``cumsum(runs)[s] + s``; positions landing at N^2 (the terminal-zero
    convention) are dropped, matching the reference's bounds check
    (entropy.c:349).
    """
    values, runs, counts = symbols
    B, S = values.shape
    s_idx = jax.lax.broadcasted_iota(jnp.int32, (B, S), dimension=1)
    pos = jnp.cumsum(runs, axis=1) + s_idx
    live = (s_idx < counts[:, None]) & (pos < n2)
    # Scatter into an n2+1 buffer; dead symbols go to the dump slot.
    target = jnp.where(live, pos, n2)
    out = jnp.zeros((B, n2 + 1), jnp.int32)
    out = out.at[jnp.arange(B)[:, None], target].add(jnp.where(live, values, 0))
    return out[:, :n2]
