"""One short run of each cell on the card, through the command a check
runs (skips without an NVIDIA GPU; the check measures the cells in
full)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import registry


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      registry.load_benchmark()["workloads"]])
def test_a_short_run_is_correct(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no "
                    "CPU mode")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          workload, "--seed", "2147483659", "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
