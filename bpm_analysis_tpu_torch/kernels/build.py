"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled on first use into ``<checkout>/.torch_build/<name>-<hash>.so``,
keyed by a hash of the source, the ``csrc/*.cuh`` headers it includes and
the flags, so an edited source or header rebuilds and an unchanged one
loads at once.  The compiler writes to a temporary
name that is renamed into place (``os.replace``): a build that is cut off
leaves no half-written library and no lock behind.  ``-Xptxas -v`` makes
ptxas report each kernel's registers, shared memory and spills;
``resources`` keeps those lines of the builds this process ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 300

_loaded: dict = {}      # name -> ctypes.CDLL
resources: dict = {}    # name -> ptxas's resource lines of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def _digest(src: Path) -> str:
    """Hash of ``src``, every ``csrc`` header it includes (transitively,
    each once, in the order first met) and the flags."""
    h = hashlib.sha256()
    seen, todo = set(), [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(text)]
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.  Raises
    with nvcc's output if the build fails or exceeds its time limit."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = _digest(src)
    target = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
        resources[name] = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                           if "registers" in line or "spill" in line]
    lib = _loaded[name] = ctypes.CDLL(str(target))
    return lib
