"""Regression guard for the jax.distributed multi-process entry path.

Runs scripts/dryrun_multiprocess.py (N=2 OS processes, loopback
coordinator, CPU backend) as a subprocess — the same path a real multi-host
deployment takes through tpuray.dist.multihost (round-3 verdict asked
for this to be suite-guarded, not script-only). Marked slow: it spawns two
fresh Python processes that each compile a small train step (~1-2 min).
"""
import pathlib
import subprocess
import sys

import pytest

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "dryrun_multiprocess.py"


@pytest.mark.slow
def test_dryrun_multiprocess_n2():
    proc = subprocess.run(
        [sys.executable, "-u", str(SCRIPT), "2"],
        capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "identical loss on all processes" in proc.stdout
