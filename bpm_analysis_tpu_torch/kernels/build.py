"""Build the CUDA kernels with ``nvcc``, load them with ``ctypes`` and
launch them: the port's one seam to its kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled on first use into ``<checkout>/.torch_build/<name>-<hash>.so``,
keyed by a hash of the source, the ``csrc/*.cuh`` headers it includes and
the flags, so an edited source or header rebuilds and an unchanged one
loads at once.  The compiler writes to a temporary
name that is renamed into place (``os.replace``): a build that is cut off
leaves no half-written library and no lock behind.  ``-Xptxas -v`` makes
ptxas report each kernel's registers, shared memory and spills;
``resources`` keeps those lines of the builds this process ran.

A wrapper under ``ops/cuda/`` declares its library's entry points once, as
data, in a :class:`Library`, and launches through it: each launch appends
the current CUDA stream of the tensors' device, turns a non-zero status
into a ``RuntimeError`` with the library's own error string, and counts a
successful launch in :data:`launches`, the one counter of kernel launches,
keyed by kernel name.  :func:`check_tensor` is the wrappers' one check of a
tensor argument's dtype, shape, device and layout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 300

_loaded: dict = {}      # name -> ctypes.CDLL
resources: dict = {}    # name -> ptxas's resource lines of this process's build
launches: Counter = Counter()   # kernel name -> successful launches in this process

PTR, I32 = ctypes.c_void_p, ctypes.c_int


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


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    launches.clear()


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device``: what a kernel reads through a bare pointer."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class Library:
    """The C interface of ``csrc/<name>.cu``, declared once.

    ``entries`` maps each entry point that launches work to its argument
    types without the trailing stream, which every call appends; each
    returns an int status, 0 for success, that ``<name>_error_string``
    explains.  ``queries`` maps the entry points that launch nothing to
    (argument types, result type).  ``check(lib)`` runs once on the loaded
    library, before its first use."""

    def __init__(self, name: str, entries: dict, queries: dict = None, check=None):
        self.name = name
        self._entries = entries
        self._queries = queries or {}
        self._check = check
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """The library, built on first use, with its signatures applied."""
        if self._lib is None:
            lib = load(self.name)
            for entry, argtypes in self._entries.items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = [*argtypes, PTR], I32
            for entry, (argtypes, restype) in self._queries.items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = argtypes, restype
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes, err.restype = [I32], ctypes.c_char_p
            if self._check is not None:
                self._check(lib)
            self._lib = lib
        return self._lib

    def _run(self, entry: str, device, args, failed: str) -> None:
        lib = self.load()
        rc = getattr(lib, entry)(*args, _stream(device))
        if rc != 0:
            msg = getattr(lib, f"{self.name}_error_string")(rc).decode()
            raise RuntimeError(f"{failed}: {msg} ({rc})")

    def launch(self, entry: str, device, *args, kernel: str = None) -> None:
        """``entry(*args, stream)`` on ``device``'s current stream, counted in
        :data:`launches` under ``kernel`` (the library's name by default)
        once it succeeds."""
        kernel = kernel or self.name
        self._run(entry, device, args, f"{kernel} kernel launch failed")
        launches[kernel] += 1

    def check_division(self, entry: str, device, *args) -> None:
        """``entry(*args, stream)``, a check of the kernel's fast division
        against IEEE division; not a kernel launch, so not counted."""
        self._run(entry, device, args, f"{self.name} division check failed")
