"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program (top-level names compared whole:
sdrangel_tpu_torch begins with sdrangel_tpu but is not it)."""

import os
import pkgutil
import subprocess
import sys

import portbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(portbench.__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "sdrangel_tpu"}


def _modules(package: str, path: str):
    yield package
    for m in pkgutil.walk_packages([path], package + "."):
        yield m.name


def _loaded_after(imports: list[str]) -> set[str]:
    code = ("import importlib, sys\n"
            f"for m in {imports!r}: importlib.import_module(m)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": ROOT})
    return set(out.stdout.split())


def test_no_module_of_the_benchmark_loads_jax():
    mods = [m for m in _modules("portbench", os.path.join(ROOT, "portbench"))
            if ".tests" not in m]
    # the drivers load the program; the metric readers are files named by metrics
    loaded = _loaded_after(mods + ["sdrangel_tpu_torch.runtime.engine",
                                   "sdrangel_tpu_torch.parallel.sharded",
                                   "sdrangel_tpu_torch.parallel.hostfeed"])
    assert "portbench" in loaded and "sdrangel_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = list(_modules("portbench.reference", os.path.join(ROOT, "portbench", "reference")))
    loaded = _loaded_after(mods)
    assert "sdrangel_tpu_torch" not in loaded and not loaded & FORBIDDEN


def test_metric_readers_load_no_program():
    from portbench import harness

    view = harness.View({}, None, {})
    for f in os.listdir(os.path.join(ROOT, "portbench", "metrics")):
        if f.endswith(".py"):
            assert harness.read_metric(f[:-3], view) is None
