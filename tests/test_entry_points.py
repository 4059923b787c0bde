"""The GPU entry points refuse to run without a GPU: they exit non-zero and
print no result line, so a CPU number is never reported as a device one."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_cpu_only_run_fails_without_result(script):
    p = _run(os.path.join(REPO, script), REPO)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert '"value"' not in p.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run("chip_smoke.py", str(tmp_path))
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
