"""chip_smoke.py on the CPU: it refuses to report without a GPU, and its
parsers, contract line and phase (c) comparisons work at tiny widths."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def test_refuses_the_cpu():
    out = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_refuses_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run("chip_smoke.py", tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_refuses_the_cpu():
    out = _run(os.path.join(REPO, "bench.py"), REPO)
    assert out.returncode != 0
    assert "value" not in out.stdout


@pytest.mark.parametrize(
    "line,name,watts",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
        ("NVIDIA H100 PCIe, 350.00 W\n", "NVIDIA H100 PCIe", 350.0),
        ("NVIDIA H100 80GB HBM3, [N/A]", "NVIDIA H100 80GB HBM3", None),
    ],
)
def test_parse_smi_line(line, name, watts):
    assert chip_smoke.parse_smi_line(line) == {"name": name, "power_limit_w": watts}


def test_parse_smi_line_rejects_other_output():
    with pytest.raises(ValueError):
        chip_smoke.parse_smi_line("No devices were found")


@pytest.mark.parametrize("count", [1, 4])
def test_contract_line(count):
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")] * count
    line = chip_smoke.contract_line(devs)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }
    assert "\n" not in line


def test_prob_deviation():
    a = np.zeros((2, 3, 4), np.float32)
    a[..., 0] = 1.0
    b = a.copy()
    b[0, 0] = [0.4, 0.6, 0.0, 0.0]
    d = chip_smoke.prob_deviation(a, b)
    assert d["max_abs"] == pytest.approx(0.6)
    assert d["mean_abs"] == pytest.approx(1.2 / a.size)
    assert d["argmax_agree"] == pytest.approx(5 / 6)
    with pytest.raises(ValueError):
        chip_smoke.prob_deviation(a, b[:1])


def test_relative_deviation_and_check():
    assert chip_smoke.relative_deviation([1.0, 2.0], [1.0, 4.0]) == pytest.approx(0.5)
    failures = []
    chip_smoke.check(failures, "small", 1e-6, 1e-5)
    chip_smoke.check(failures, "agree", 0.99, 0.97, at_least=True)
    assert failures == []
    chip_smoke.check(failures, "big", 1e-3, 1e-5)
    chip_smoke.check(failures, "disagree", 0.5, 0.97, at_least=True)
    assert len(failures) == 2 and failures[0].startswith("big")


def test_compare_deconv_tiny():
    out = chip_smoke.compare_deconv(batch=2, shapes=((2, (5, 7)), (8, (3, 4))))
    assert out["k4s2_5x7"]["out"] == [2, 10, 14, 11]
    assert out["k16s8_3x4"]["out"] == [2, 24, 32, 11]
    assert all(v["rel_max"] <= chip_smoke.DECONV_REL_MAX for v in out.values())


def test_compare_reference_tiny():
    """Phase (c) at a tiny width: the 'card' and the host are both the CPU
    here, so f32 agrees exactly; bf16 and the folded tail stay in band."""
    out = chip_smoke.compare_reference(
        jax.devices("cpu")[0], fc_channels=16, hw=(64, 96), dae_widths=(8, 16, 32)
    )
    assert out["f32_card_vs_host"]["max_abs"] == 0.0
    assert out["bf16_vs_f32"]["argmax_agree"] >= chip_smoke.BF16_ARGMAX_AGREE_MIN
    assert out["folded_vs_unfolded_f32"]["max_abs"] <= chip_smoke.FOLD_MAX


def test_failed_band_raises():
    with pytest.raises(chip_smoke.PhaseFailed, match="want <="):
        chip_smoke._finish(["x = 1, want <= 0"], {"x": 1})
