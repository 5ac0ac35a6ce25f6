"""The port's four examples (`examples/torch_*.py`) run on the CPU at the
reference's smoke sizes (`tests/test_examples.py`'s arguments) and
print the lines that `tests/test_examples.py` asserts of the reference's
examples. Where the reference prints roots or digests of inputs both
packages build bit for bit, the port prints the same ones: the
quickstart's Merkle root and derived seed, and every line of the
consortium (its element ids, gossip bytes, trust scores and merged
magnitudes), each compared with the reference example run in this
process. The fine-tuning examples print roots of trained parameters,
which the two packages hold to a tolerance, not to the bit, so those
are not compared. `torch_serve_merged.py` also serves Qwen3-MoE's smoke
model.
"""
import contextlib
import io
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(script, *args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args], capture_output=True, text=True, env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _reference(script):
    """The reference example's standard output, run in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "examples" / script), run_name="__main__")
    return buf.getvalue()


def _line(out, prefix):
    return next(ln for ln in out.splitlines() if ln.startswith(prefix))


def test_torch_quickstart():
    """The reference's asserted lines; the Merkle root and derived seed
    equal the reference's."""
    out = _run("torch_quickstart.py")
    assert out.count("True") >= 6
    assert "after retraction" in out
    ref = _reference("quickstart.py")
    for prefix in ("merkle root:", "derived seed:", "after retraction",
                   "all 26 strategies"):
        assert _line(out, prefix) == _line(ref, prefix)


def test_torch_consortium():
    """The reference's asserted lines; every line equal to the
    reference's (roots by partition, gossip bytes, the flagged element
    id, its trust, the gated and ungated magnitudes)."""
    out = _run("torch_decentralized_consortium.py")
    assert "healed: all 10 nodes converged" in out
    assert "gated merge excludes the poisoned model" in out
    assert out.splitlines() == _reference(
        "decentralized_consortium.py").splitlines()


def test_torch_btm_train_fast():
    out = _run("torch_btm_train.py", "--rounds", "2", "--merge-every", "3",
               "--branches", "2", "--seq", "32", "--batch", "4")
    assert "merged model per-task eval loss" in out


@pytest.mark.parametrize("arch", [[], ["--arch", "qwen3-moe-30b-a3b"]])
def test_torch_serve_merged(arch):
    out = _run("torch_serve_merged.py", "--batch", "2", "--gen", "4", *arch)
    assert "served 2 requests" in out
    assert "merged 2 contributions via TIES" in out
