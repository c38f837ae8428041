"""chip_smoke.py refuses to report a result without a GPU or without the
rest of the repository: it exits non-zero and prints no `ok` line."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"


@pytest.mark.parametrize("where", ["cpu_only", "script_alone"])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, where):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    script = SCRIPT
    if where == "script_alone":
        script = tmp_path / SCRIPT.name
        shutil.copy(SCRIPT, script)
    result = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                            env=env, capture_output=True, text=True,
                            timeout=300)
    assert result.returncode != 0
    assert '"ok"' not in result.stdout
