"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX package
`gnnla_tpu`; top-level module names are compared whole, so the port
`gnnla_tpu_torch` passes."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gnnla_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax():
    seen = set()
    for base, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(base, f)):
                    seen.add(mod.split(".")[0])
    assert "gnnla_tpu_torch" in seen and "torch" in seen
    assert not seen & FORBIDDEN, sorted(seen & FORBIDDEN)


def test_forbidden_compares_whole_names(monkeypatch):
    from perfbench import harness
    for name in ("gnnla_tpu_torch.fake", "jaxtyping_fake", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in FORBIDDEN for m in harness.forbidden_modules())
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "gnnla_tpu.fake", object())
    assert set(harness.forbidden_modules()) - before == {"gnnla_tpu.fake"}


def test_a_run_loads_no_jax(tiny_root):
    """A whole run on the CPU, in a fresh process: the harness, each
    driver, the port's modules they load and the readers; then
    sys.modules holds no forbidden name."""
    code = f"""
import sys, time
sys.path.insert(0, {ROOT!r})
from perfbench import harness
for w in ("poisson2d_5pt_2048.solve", "poisson2d_5pt_2048.matvec"):
    harness.execute(harness.Cell(w, {tiny_root!r}), 7, 0.2, True, "cpu",
                    time.perf_counter())
print(sorted(m for m in sys.modules
             if m.split(".")[0] in {sorted(FORBIDDEN)!r}))
print("gnnla_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "True"], out.stdout
