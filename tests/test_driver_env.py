"""Run ``dryrun_multichip`` the way a user calls it: in a fresh process.

The in-repo multi-device tests pass partly because tests/conftest.py forces
the CPU platform for the whole process before JAX starts. A plain
``import __graft_entry__; dryrun_multichip(n)`` gets no such help, so this
test runs the dryrun in a **fresh subprocess without the conftest's
forcing** (JAX_PLATFORMS unset) and asserts that it pins the CPU itself,
before any backend is touched, and succeeds.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run_dryrun(n: int):
    env = dict(os.environ)
    # undo the conftest's process-level CPU forcing: a user's process has
    # only the host-device-count flag
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    r = subprocess.run(
        [sys.executable, "-c",
         f"import __graft_entry__ as g; g.dryrun_multichip({n})"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, (
        f"dryrun({n}) failed in a fresh process:\n"
        f"stdout: {r.stdout[-1500:]}\nstderr: {r.stderr[-3000:]}")
    assert f"dryrun_multichip({n})" in r.stdout
    return r.stdout


def test_dryrun_multichip_in_driver_env():
    _run_dryrun(8)


# Width sweep (VERDICT r3 #8): the loud-skip branches must stay exercised —
# n=2 takes the <3-devices PP-skip path, n=3 is the exact 3-stage fit, and
# n=6 has no (data, model) factorization for mnist_nn (batch 64: 6/3 and
# 6/2 both leave a non-dividing data axis) so the DPxTP sections skip.
@pytest.mark.parametrize("n", [2, 3, 6])
def test_dryrun_multichip_width_sweep(n):
    out = _run_dryrun(n)
    if n == 2:
        assert "skipping the 3-stage hetero U-Net pipeline section" in out
    else:
        assert "PP U-Net train step loss=" in out
    if n == 6:
        assert "no (data, model) factorization fits mnist_nn" in out
        # a skipped check must not read like a passing one (ADVICE r3)
        assert "ce=skipped" in out and "DPxTP loss=skipped" in out
