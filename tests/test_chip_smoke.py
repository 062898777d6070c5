"""chip_smoke.py on the CPU: it refuses to report a result without a GPU,
and its model phases and the four-card comparison run at tiny size."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    return tmp_path


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_rejects_unknown_options():
    assert chip_smoke.main(["--eight-cards"]) == 2


def test_phase_unet_tiny(data_dir):
    out = chip_smoke.phase_unet(data_dir, tiny=True)
    assert len(out["losses"]) == 3
    assert (data_dir / "cifar_unet" / "samples" / "sample_1.bmp").is_file()


def test_phase_mnist_tiny(data_dir):
    out = chip_smoke.phase_mnist(data_dir, tiny=True)
    assert "correct" in out["run"] and len(out["losses"]) == 2


def test_dp_reference_matches_dp_step_on_4_devices():
    """The --four-cards comparison, rehearsed on 4 virtual CPU devices: the
    shard_map DP step equals the one-device reference of its math."""
    from big_linear_algebra.models import cifar_unet as cu

    cfg = dataclasses.replace(cu.TINY, batch_size=8)
    r = chip_smoke.compare_dp(jax.devices()[:4], cfg, steps=2)
    assert r["loss_rel_diff"] <= 1e-5, r
    assert r["max_param_diff"] <= 1e-5, r
    assert r["dp_losses"][0] != r["dp_losses"][1]
