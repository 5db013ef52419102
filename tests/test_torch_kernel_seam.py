"""The port's one seam to its CUDA kernels, on the CPU.

* Layering, read from the package's sources with ``ast``: each wrapper
  under ``ops/cuda/`` imports nothing from ``models/`` and not the module
  that dispatches to it; exactly one package module imports it, the one
  that holds its plain version and makes its CPU-or-card choice; and no
  wrapper keeps a library loader, an error lookup, a stream lookup or a
  launch counter of its own (``kernels/build`` holds the one of each).
* The launcher (``kernels/build.Library``) against a fake library: the
  declared signatures are applied once, the stream is appended, a
  non-zero status raises the kernel's message, and only successful
  launches are counted.
"""
import ast
import ctypes
import types
from collections import Counter
from pathlib import Path

import pytest
import torch

from bpm_analysis_tpu_torch.kernels import build

PACKAGE = Path(build.__file__).resolve().parents[1]
ROOT = PACKAGE.name
# Each wrapper and the one module that makes its CPU-or-card choice.
DISPATCHER = {
    "row_quantile_kernel": "ops.quantile",
    "rolling_quantile_kernel": "ops.quantile",
    "quantile_kernel": "ops.quantile",
    "knot_kernel": "ops.knot_quantile",
    "filter_kernel": "ops.filter",
    "rhythm_kernel": "models.corrections",
    "classify_kernel": "models.classifier",
    "metrics_kernel": "models.analytics",
}


def _module_name(path: Path) -> str:
    rel = path.relative_to(PACKAGE).with_suffix("")
    parts = [p for p in rel.parts if p != "__init__"]
    return ".".join([ROOT, *parts])


def _imports(path: Path) -> set:
    """The package modules ``path`` imports, anywhere in it, as dotted names
    (``from X import y`` counts as ``X.y`` where that is a module)."""
    name = _module_name(path)
    package = name if path.name == "__init__.py" else name.rpartition(".")[0]
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")[:len(package.split(".")) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            found.add(mod)
            for alias in node.names:
                sub = f"{mod}.{alias.name}"
                if _is_module(sub):
                    found.add(sub)
    return {m for m in found if m == ROOT or m.startswith(ROOT + ".")}


def _is_module(dotted: str) -> bool:
    rel = Path(*dotted.split(".")[1:])
    return ((PACKAGE / rel).with_suffix(".py").exists()
            or (PACKAGE / rel / "__init__.py").exists())


SOURCES = sorted(PACKAGE.rglob("*.py"))
IMPORTS = {_module_name(p): _imports(p) for p in SOURCES}
WRAPPERS = sorted(p.stem for p in (PACKAGE / "ops" / "cuda").glob("*.py")
                  if p.stem != "__init__")


def test_every_wrapper_has_one_dispatcher():
    assert WRAPPERS == sorted(DISPATCHER)


@pytest.mark.parametrize("wrapper", sorted(DISPATCHER))
def test_wrapper_imports_no_model_and_not_its_dispatcher(wrapper):
    imported = IMPORTS[f"{ROOT}.ops.cuda.{wrapper}"]
    assert not {m for m in imported if m.startswith(f"{ROOT}.models")}, imported
    assert f"{ROOT}.{DISPATCHER[wrapper]}" not in imported


@pytest.mark.parametrize("wrapper", sorted(DISPATCHER))
def test_wrapper_is_imported_by_its_dispatcher_alone(wrapper):
    importers = {mod for mod, imported in IMPORTS.items()
                 if f"{ROOT}.ops.cuda.{wrapper}" in imported}
    assert importers == {f"{ROOT}.{DISPATCHER[wrapper]}"}


@pytest.mark.parametrize("wrapper", sorted(DISPATCHER))
def test_wrapper_keeps_no_loader_error_lookup_stream_or_counter(wrapper):
    tree = ast.parse((PACKAGE / "ops" / "cuda" / f"{wrapper}.py").read_text())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not any(isinstance(n, ast.Global) for n in ast.walk(tree))
    assert not names & {"CDLL", "current_stream", "cuda_stream", "launches"}, names
    assert not any(name.endswith("error_string") for name in names)
    build_calls = {n.func.attr for n in ast.walk(tree)
                   if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                   and isinstance(n.func.value, ast.Name) and n.func.value.id == "build"}
    assert "load" not in build_calls


# ---------------------------------------------------------------------------
# The launcher against a fake library
# ---------------------------------------------------------------------------

def _fake(statuses, calls):
    """A stand-in for a loaded library ``fake``: ``fake_run`` and
    ``fake_check_division`` return the next status of ``statuses`` and
    record their arguments."""
    def entry():
        def run(*args):
            calls.append(args)
            return statuses.pop(0)
        return run

    def error_string(rc):
        return f"error {rc}".encode()

    def query(x):
        return 2 * x

    return types.SimpleNamespace(fake_run=entry(), fake_check_division=entry(),
                                 fake_query=query, fake_error_string=error_string)


@pytest.fixture
def fake_library(monkeypatch):
    statuses, calls, loads, checks = [], [], [], []
    lib = _fake(statuses, calls)

    def load(name):
        loads.append(name)
        return lib

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(build, "_stream", lambda device: 77)
    monkeypatch.setattr(build, "launches", Counter())
    library = build.Library("fake", {"fake_run": [build.PTR, build.I32],
                                     "fake_check_division": [build.I32]},
                            queries={"fake_query": ([build.I32], build.I32)},
                            check=checks.append)
    return types.SimpleNamespace(library=library, lib=lib, statuses=statuses, calls=calls,
                                 loads=loads, checks=checks)


def test_launcher_applies_the_declared_signatures_once(fake_library):
    f = fake_library
    assert f.library.load() is f.lib and f.library.load() is f.lib
    assert f.loads == ["fake"] and f.checks == [f.lib]
    assert f.lib.fake_run.argtypes == [build.PTR, build.I32, build.PTR]   # the stream last
    assert f.lib.fake_run.restype is build.I32
    assert f.lib.fake_query.argtypes == [build.I32] and f.lib.fake_query.restype is build.I32
    assert f.lib.fake_error_string.argtypes == [build.I32]
    assert f.lib.fake_error_string.restype is ctypes.c_char_p
    assert f.library.load().fake_query(21) == 42


def test_launcher_appends_the_stream_and_counts_successful_launches(fake_library):
    f = fake_library
    f.statuses += [0, 0, 0]
    f.library.launch("fake_run", "cpu", 5, 6)
    f.library.launch("fake_run", "cpu", 7, 8)
    f.library.launch("fake_run", "cpu", 9, 10, kernel="fake_phase")
    assert f.calls == [(5, 6, 77), (7, 8, 77), (9, 10, 77)]
    assert build.launches == Counter(fake=2, fake_phase=1)
    build.reset_launches()
    assert build.launches["fake"] == 0 and not build.launches


def test_launcher_raises_the_kernels_message_and_counts_no_failed_launch(fake_library):
    f = fake_library
    f.statuses += [3, 4, 0, 5]
    with pytest.raises(RuntimeError, match=r"^fake kernel launch failed: error 3 \(3\)$"):
        f.library.launch("fake_run", "cpu", 1, 2)
    with pytest.raises(RuntimeError,
                       match=r"^fake_phase kernel launch failed: error 4 \(4\)$"):
        f.library.launch("fake_run", "cpu", 1, 2, kernel="fake_phase")
    assert not build.launches
    f.library.check_division("fake_check_division", "cpu", 1)
    with pytest.raises(RuntimeError, match=r"^fake division check failed: error 5 \(5\)$"):
        f.library.check_division("fake_check_division", "cpu", 1)
    assert not build.launches             # a division check is not a kernel launch


@pytest.mark.parametrize("bad, what", [
    (torch.zeros((2, 3), dtype=torch.float64), "expected"),
    (torch.zeros((3, 2), dtype=torch.float32), "expected"),
    (torch.zeros((2, 3), dtype=torch.float32, device="meta"), "expected"),
    (torch.zeros((3, 2), dtype=torch.float32).t(), "contiguous"),
], ids=["dtype", "shape", "device", "layout"])
def test_check_tensor_rejects_what_a_kernel_cannot_read(bad, what):
    build.check_tensor("ok", torch.zeros((2, 3), dtype=torch.float32), torch.float32, (2, 3),
                       torch.device("cpu"))
    with pytest.raises(ValueError, match=what):
        build.check_tensor("t", bad, torch.float32, (2, 3), torch.device("cpu"))
