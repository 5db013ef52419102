"""The harness refuses to run without a card, without the program, and
loads neither JAX nor the JAX package."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_port import core

# Each cell at its recordings' own length, with few of them: the upstream
# answers exist for ten-minute recordings only.
SMALL = {
    "fleet-b512": {"traffic": {"batch": 2}, "warmup_calls": 1},
    "serial-native-10min": {"traffic": {"files": 1}, "warmup_calls": 0},
}


def test_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from bench_port import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "fleet-b512", "--seed", str(2**31 + 5),
                     "--seconds", "1", "--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA card" in out.err


def test_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(core.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from bench_port import core; "
            f"core.run_cell('fleet-b512', 3, 0.1, False, 'cpu', overrides={SMALL['fleet-b512']!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and proc.stdout == ""
    assert "bpm_analysis_tpu_torch" in proc.stderr


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _modules(sub: str = "") -> list:
    out = []
    for d, _, files in os.walk(os.path.join(core.HERE, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in _modules():
        assert not _imports(path) & set(core.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in _modules("reference"):
        assert "bpm_analysis_tpu_torch" not in _imports(path), path
        with open(path) as f:
            assert "import bpm_analysis_tpu" not in f.read()


def test_forbidden_modules_compare_whole_names():
    assert core.forbidden_modules(["bpm_analysis_tpu_torch.models.pipeline", "jaxtyping",
                                   "flaxen", "numpy"]) == []
    assert core.forbidden_modules(["bpm_analysis_tpu.ops", "jax.numpy", "jaxlib",
                                   "flax.linen"]) == ["bpm_analysis_tpu", "flax", "jax", "jaxlib"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_dry_run_loads_no_jax(cell):
    """A CPU run of the cell's whole path at a small size, in a fresh
    process: correct, and no JAX, Flax or JAX package in ``sys.modules``."""
    code = ("import json, sys; sys.path.insert(0, '.'); from bench_port import core\n"
            "if __name__ == '__main__':\n"
            f"    r = core.run_cell({cell!r}, 2**31 + 11, 0.1, False, 'cpu', overrides={SMALL[cell]!r})\n"
            "    print(json.dumps([r['correct'], core.forbidden_modules(), "
            "sorted(m for m in sys.modules if m.startswith('bpm_analysis_tpu_torch'))[:3]]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    correct, forbidden, port = json.loads(proc.stdout.strip().splitlines()[-1])
    assert correct and forbidden == [] and port
