"""Measurement entry points refuse to run without a GPU.

A time, a rate or a smoke result taken on the CPU would be read as a
device number; bench.py, benchmarks/ladder.py and chip_smoke.py exit
non-zero instead, printing no result. chip_smoke.py's phases themselves
run only on the card.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.parametrize("script", [
    ["chip_smoke.py"], ["chip_smoke.py", "--cards", "4"], ["bench.py"],
    ["benchmarks/ladder.py", "--quick"],
])
def test_exits_nonzero_without_a_gpu(script):
    _no_result(_run(script))


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _no_result(_run(["chip_smoke.py"], cwd=tmp_path))


def test_chip_smoke_agreement_measure():
    sys.path.insert(0, REPO)
    import chip_smoke

    want = np.ones((10, 3), np.float32)
    got = want.copy()
    got[0] = 2.0  # one pixel off, the rest identical
    a = chip_smoke._agreement(got, want)
    assert a["pixels_close"] == pytest.approx(0.9)
    assert a["mean_rel_diff"] == pytest.approx(0.1)
    got[1] = 1.0 + 5e-3  # inside rtol 1e-2
    assert chip_smoke._agreement(got, want)["pixels_close"] == (
        pytest.approx(0.9))
