"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phase functions work at tiny sizes (the card runs them at full size)."""
import os
import subprocess
import sys

import jax
import pytest

from conftest import REPO

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_solve_routes_tiny():
    chip_smoke.phase_solve_routes(cases=((8, 16), (26, 8), (40, 4)),
                                  n_ref=8)


@pytest.mark.parametrize("schedule", ["device", "host"])
def test_phase_sweep_tiny(schedule):
    conv = chip_smoke.phase_sweep("net2", 5, 16, schedule, n_sample=4)
    assert conv == 1.0


def test_phase_f64_parity_tiny():
    chip_smoke.phase_f64_parity("net2", 5)


def test_phase_cli_tiny(capsys):
    chip_smoke.phase_cli(batch=8, h_max=5)
    assert "conv=1.0000" in capsys.readouterr().out


def test_phase_multichip_tiny():
    assert len(jax.devices()) >= 4
    chip_smoke.phase_multichip(n_devices=4, B_per_card=4, h_max=5)


def test_phase_error_is_raised():
    with pytest.raises(chip_smoke.PhaseError, match="boom"):
        chip_smoke.check(False, "boom")
