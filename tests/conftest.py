"""Test configuration: run JAX on CPU with 8 virtual devices so sharding
tests (parallel/) exercise a real 8-way mesh without accelerator hardware,
per SURVEY.md section 4 (multi-host testing strategy).

jax.config.update after import is the authoritative override of any
platform set in the environment (it must happen before any backend
initialization, hence here in conftest before any dct_tpu import).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
# Entry points under test (cli.main) point JAX's persistent compilation
# cache into the checkout; keep the suite hermetic instead.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu():
    assert jax.default_backend() == "cpu", (
        "tests must run on the CPU backend (8 virtual devices); got "
        f"{jax.default_backend()}"
    )


# The XLA CPU jit cache never evicts, and each compiled executable holds
# several mmap regions; a full one-process suite run compiles enough
# distinct shapes to hit vm.max_map_count (~65530) and die in a compile
# SEGFAULT around the 85% mark (observed 2026-08-20; CLAUDE.md documents
# the same cliff for long benchmark processes). jax.clear_caches() DOES
# munmap released executables (measured: 642 -> 463 regions), so drain
# the cache between modules once the process is past half the limit —
# recompiles cost a few minutes at most, a segfaulted suite costs the
# run.
_MAPS_DRAIN_THRESHOLD = 32_000


def _map_count() -> int:
    try:
        with open(f"/proc/{os.getpid()}/maps") as f:
            return sum(1 for _ in f)
    except OSError:  # non-Linux: no cliff to dodge
        return 0


@pytest.fixture(scope="module", autouse=True)
def _drain_jit_cache_near_map_limit():
    yield
    if _map_count() > _MAPS_DRAIN_THRESHOLD:
        jax.clear_caches()


@pytest.fixture(scope="session")
def golden_block() -> np.ndarray:
    """The classic JPEG textbook 8x8 block, the reference's shared fixture
    (duplicated at test_dct.c:33-42 and test_entropy.c:290-299)."""
    return np.array(
        [
            [52, 55, 61, 66, 70, 61, 64, 73],
            [63, 59, 55, 90, 109, 85, 69, 72],
            [62, 59, 68, 113, 144, 104, 66, 73],
            [63, 58, 71, 122, 154, 106, 70, 69],
            [67, 61, 68, 104, 126, 88, 68, 70],
            [79, 65, 60, 70, 77, 68, 58, 75],
            [85, 71, 64, 59, 55, 61, 65, 83],
            [87, 79, 69, 68, 65, 76, 78, 94],
        ],
        dtype=np.uint8,
    )


@pytest.fixture(scope="session")
def oracle():
    from dct_tpu import oracle as _oracle

    if not _oracle.available():
        pytest.skip("C oracle unavailable (no compiler or reference mount)")
    return _oracle
