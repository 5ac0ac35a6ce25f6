"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the plain references load nothing of the program."""
import subprocess
import sys

from conftest import ROOT

PRELUDE = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r},
                {str(ROOT / 'portbench' / 'tests')!r}]
"""


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_every_module_and_a_run_load_no_jax():
    code = """
import importlib, pkgutil, time, torch
import portbench
from portbench import registry, run
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
for m in registry.load_benchmark()["per_layer"]:
    registry.reader(m["name"])
import tiny
for w, kw in [("phi3-merge-sweep", dict(sample_width=64, sample_blocks=2)),
              ("mamba2-finetune", dict(seq_len=32))]:
    run.run_cell(tiny.cell(w, **kw), seed=1, seconds=0.5, trace=True,
                 device=torch.device("cpu"), t_start=time.perf_counter())
print(sorted({n.split(".")[0] for n in sys.modules}
             & {"jax", "jaxlib", "flax", "repro"}), "repro_torch" in sys.modules)
"""
    assert _run(code) == "[] True"


def test_the_references_load_nothing_of_the_program():
    code = """
import importlib, pkgutil
import portbench.reference as r
for m in pkgutil.walk_packages(r.__path__, "portbench.reference."):
    importlib.import_module(m.name)
print(sorted({n.split(".")[0] for n in sys.modules}
             & {"jax", "jaxlib", "flax", "repro", "repro_torch"}))
"""
    assert _run(code) == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()
