"""Pin the scaling analysis in compiled HLO (round-3 VERDICT item 8).

BASELINE.md's "<0.1% communication" claim rests on the sharded encode
issuing exactly the collectives the design calls for (SURVEY.md section
5.8) and not one more:

  * static-table single-dispatch encode (_encode_step_sharded) — ZERO
    collectives: stripes are independent, tables are baked in.
  * dynamic-table analyze phase — ONE integer all-reduce (the category
    histogram psum), plus one more for the run histogram when coded_runs.
  * stripe_byte_offsets — ONE all-gather of the (n_stripes,) i32 bit
    lengths (n_stripes * 4 bytes on the wire).

If anyone adds an accidental collective (e.g. a stray resharding
all-to-all from a bad with_sharding_constraint), these tests fail.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dct_tpu.config import CodecConfig
from dct_tpu.ops import transform
from dct_tpu.parallel import mesh as meshlib
from dct_tpu.parallel import shard_encode

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

# Collective-op mnemonics in post-partitioning optimized HLO. "-start"
# variants cover async lowering; "-done" is the completion of the same
# op, so it is excluded from counts. The result type between "=" and the
# opcode may be a TUPLE for variadic collectives (e.g. a multi-operand
# psum lowers to "= (s32[2]{0}, s32[8]{0}) all-reduce(...)"), so the
# type matcher must span parenthesized, space-containing types — a bare
# \S* missed those entirely and the zero-collective guards passed
# vacuously for variadic regressions.
_COLLECTIVE_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?\S+\s*=\s*(?:\([^)]*\)|\S+)\s*("
    r"all-reduce|all-gather|all-to-all|collective-permute|reduce-scatter"
    r")(?:-start)?\(",
)


def collective_counts(compiled_text: str) -> dict[str, int]:
    counts: dict[str, int] = {}
    for line in compiled_text.splitlines():
        m = _COLLECTIVE_RE.match(line)
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def _compiled_text(jitted, *args) -> str:
    return jitted.lower(*args).compile().as_text()


@pytest.fixture(scope="module")
def mesh():
    return meshlib.make_mesh()  # 1 x 8


class TestStaticStepHasNoCollectives:
    @pytest.mark.parametrize("adaptive", (False, True))
    def test_encode_step_sharded(self, mesh, adaptive):
        """The single-dispatch static-table sharded encode is pure SPMD —
        0 collectives, 0 cross-device bytes."""
        cfg = CodecConfig(quality=50, adaptive=adaptive, static_tables=True)
        img = jnp.zeros((128, 96), jnp.uint8)
        img = jax.device_put(
            img, NamedSharding(mesh, P(meshlib.STRIPE_AXIS, None))
        )
        txt = _compiled_text(
            shard_encode._encode_step_sharded, img, cfg, 16, mesh
        )
        assert collective_counts(txt) == {}, collective_counts(txt)

    def test_encode_batch_step(self):
        """The dp x sp batched step is likewise collective-free."""
        mesh2x4 = meshlib.make_mesh(n_data=2, n_stripe=4)
        cfg = CodecConfig(quality=50, static_tables=True)
        frames = jnp.zeros((2, 128, 96), jnp.uint8)
        fr = jax.device_put(frames, meshlib.frame_sharding(mesh2x4))
        step = shard_encode._batch_step(cfg, 16, mesh2x4)
        txt = _compiled_text(step, fr)
        assert collective_counts(txt) == {}, collective_counts(txt)


class TestDynamicTableCollectives:
    def test_category_histogram_is_one_allreduce(self, mesh):
        """Histogram globalization = exactly ONE all-reduce (an integer
        psum of the (17,) category histogram)."""
        v = jnp.zeros((160, 64), jnp.int32)
        m = jnp.ones((160, 64), jnp.bool_)
        sh = NamedSharding(mesh, P(meshlib.STRIPE_AXIS, None))
        v, m = jax.device_put(v, sh), jax.device_put(m, sh)
        txt = _compiled_text(
            jax.jit(
                lambda a, b: shard_encode.global_category_histogram(
                    a, b, mesh
                )
            ),
            v, m,
        )
        counts = collective_counts(txt)
        assert counts.get("all-reduce", 0) == 1, counts
        assert set(counts) <= {"all-reduce"}, counts

    def test_run_histogram_is_one_allreduce(self, mesh):
        r = jnp.zeros((160, 64), jnp.int32)
        m = jnp.ones((160, 64), jnp.bool_)
        sh = NamedSharding(mesh, P(meshlib.STRIPE_AXIS, None))
        r, m = jax.device_put(r, sh), jax.device_put(m, sh)
        txt = _compiled_text(
            jax.jit(
                lambda a, b: shard_encode.global_run_histogram(a, b, mesh)
            ),
            r, m,
        )
        counts = collective_counts(txt)
        assert counts.get("all-reduce", 0) == 1, counts
        assert set(counts) <= {"all-reduce"}, counts

    def test_stripe_offsets_is_one_allgather_of_bit_lengths(self, mesh):
        """Offset exchange = ONE all-gather whose payload is the
        (n_stripes,) i32 bit-length vector — 4 * n_stripes bytes."""
        n_stripes = 16
        bits = jnp.zeros((n_stripes,), jnp.int32)
        bits = jax.device_put(
            bits, NamedSharding(mesh, P(meshlib.STRIPE_AXIS))
        )
        txt = _compiled_text(
            jax.jit(lambda b: shard_encode.stripe_byte_offsets(b, mesh)),
            bits,
        )
        counts = collective_counts(txt)
        assert counts.get("all-gather", 0) == 1, counts
        assert set(counts) <= {"all-gather"}, counts
        # the gathered operand is the s32[2] local shard -> s32[16] global:
        # assert the all-gather output is exactly the bit-length vector,
        # not something larger a regression might smuggle in
        m = re.search(r"= s32\[(\d+)\]\{0\} all-gather", txt)
        assert m, "all-gather of s32 vector not found in HLO"
        assert int(m.group(1)) == n_stripes

    def test_decode_step_has_no_collectives(self, mesh):
        """Sharded dequant+IDCT reconstructs rows in place — 8x8 blocks
        share no pixels, so decode needs zero cross-device traffic."""
        from dct_tpu.ops import blocks as blk

        cfg = CodecConfig(quality=50, static_tables=True)
        bh, bw, n = 16, 12, 8
        zz = jnp.zeros((bh * bw, 64), jnp.int16)
        sh = NamedSharding(mesh, P(meshlib.STRIPE_AXIS, None))
        zz = jax.device_put(zz, sh)

        @jax.jit
        def step(z):
            px = transform.decode_blocks(z, cfg)
            px = jax.lax.with_sharding_constraint(px, sh)
            return blk.blocks_to_image(px, bh * n, bw * n, n)

        txt = _compiled_text(step, zz)
        counts = collective_counts(txt)
        assert counts == {}, counts
