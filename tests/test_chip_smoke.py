"""chip_smoke.py on the CPU: it must refuse to run without a GPU (and
without the rest of the repository), and its phases — every comparison it
makes on the card — must pass at tiny shapes here."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run_script(path: pathlib.Path, cwd: pathlib.Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(path)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _assert_refused(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (json.JSONDecodeError, AttributeError):
            pass


def test_exits_nonzero_without_gpu():
    _assert_refused(_run_script(REPO / "chip_smoke.py", REPO))


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    _assert_refused(_run_script(tmp_path / "chip_smoke.py", tmp_path))


def test_phase_gray_batch_tiny():
    out = chip_smoke.phase_gray_batch(2, 40, 64)
    assert set(out) == {"q50_static", "q90_dynamic"}
    assert out["q90_dynamic"]["psnr_db"] > out["q50_static"]["psnr_db"]


def test_phase_color_still_tiny():
    assert chip_smoke.phase_color_still(48, 64)["psnr_db"] > 25


def test_phase_video_tiny():
    assert chip_smoke.phase_video(3, 40, 64)["bytes"] > 0


def test_phase_rate_tiny():
    out = chip_smoke.phase_rate(64, 96)
    assert out["bytes"] <= out["budget"]


def test_phase_cli_tiny(tmp_path):
    assert chip_smoke.phase_cli(40, 64, tmp_path)["bytes"] > 0


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 devices")
def test_phase_sharded_tiny():
    out = chip_smoke.phase_sharded(64, 96, 48, 64, jax.devices()[:4])
    assert out["rate_1x4"]["bytes"] > 0


def test_check_raises():
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.check(False, "x")


def test_parity_uses_c_oracle_when_available(monkeypatch):
    """With the reference available, parity also runs the C oracle's
    dct_forward/quantize; here a float64 numpy stand-in plays it."""
    import numpy as np

    from dct_tpu import oracle, tables
    from dct_tpu.config import CodecConfig

    d = tables.dct_basis(8)
    q = tables.quant_matrix(8, 50)
    monkeypatch.setattr(oracle, "available", lambda: True)
    monkeypatch.setattr(oracle, "dct_forward", lambda b: d @ b @ d.T)
    monkeypatch.setattr(
        oracle, "quantize",
        lambda c, quality: np.trunc(c / q + np.where(c >= 0, 0.5, -0.5)),
    )
    frames = np.stack([chip_smoke.photo(32, 48, 1)])
    out = chip_smoke.parity_f64(frames, CodecConfig(quality=50))
    assert out["c_oracle"] == "24 blocks agree up to ties"
