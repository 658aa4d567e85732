"""``chip_smoke.py`` refuses to run without a GPU.

The smoke test's phases need an NVIDIA card (they run there through
``python chip_smoke.py``); on this CPU-only suite the script must exit
non-zero with its no-GPU message and print no result line — both from the
repository and from a directory that holds nothing else of it.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_cpu(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no GPU" in proc.stdout
    assert '"ok"' not in proc.stdout


def test_chip_smoke_rehearsal_passes_on_cpu():
    """``--rehearse`` runs every one-card phase at toy sizes on the CPU:
    the script's problems, references and checks agree end to end (its
    times mean nothing here)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--rehearse"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith('{"ok": true, "device": {"platform": "cpu"')
    for phase in ("phase 1", "phase 2", "phase 3", "phase 4", "phase 5"):
        assert phase in proc.stdout
    assert "FAIL" not in proc.stdout
