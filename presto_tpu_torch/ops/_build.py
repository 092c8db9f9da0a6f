"""Build and load the port's CUDA kernels.

Each ``presto_tpu_torch/csrc/<name>.cu`` is compiled at first use, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC``, into ``build/lib<name>.so`` at the root of the checkout (listed
in ``.gitignore``), and loaded with ``ctypes``. The sources expose a
plain C interface, so a build takes seconds; nothing is prebuilt and
nothing comes from outside the checkout. ``build()`` starts one ``nvcc``
per stale source, all at once, and waits for them together.

A failed build raises; no caller falls back to the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

from presto_tpu_torch.runtime.errors import InternalError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's standard install location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return max(p.stat().st_mtime for p in deps) > lib.stat().st_mtime


def build(names=None) -> dict[str, str]:
    """Compile the stale kernels among ``names`` (default: all) with one
    ``nvcc`` each, started together. Returns each build's compiler
    output (register and shared-memory use, from ``-Xptxas -v``)."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise InternalError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if code != 0:
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        msg = err(code).decode()
        raise InternalError(f"CUDA kernel {name} failed to launch: {msg} ({code})")
