"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``kernels/**/csrc/`` has a plain C interface and
is compiled by ``nvcc`` into its own shared library, loaded with ctypes
(no PyTorch headers, so a build takes seconds, not minutes).  Libraries
go to ``build/kernels/`` at the repository root, named after a hash of
the source bytes, the bytes of every local header it includes
(``#include "..."``, followed recursively), the flags and the compiler
path, so a stale library is never loaded: editing a source, a shared
header or a flag changes the name.  The build
runs at first use, never at import, and writes to a temporary name that
is renamed into place, so concurrent builders cannot load a half-written
file.  Each kernel module passes its own flags (``flags=``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

#: Hopper only (``sm_90a`` keeps wgmma/setmaxnreg available to later
#: kernels).  No --use_fast_math: it turns exp2f/log2f and division into
#: approximations.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    """``nvcc`` on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                       "port's CUDA kernels are built on the machine "
                       "with the card")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_includes(source: Path) -> list:
    """The local headers ``source`` includes (``#include "..."``,
    relative to the including file), recursively, each once, in the
    order first met."""
    seen, todo = [], [source.resolve()]
    while todo:
        path = todo.pop(0)
        for rel in _LOCAL_INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / rel.decode()).resolve()
            if dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def library_path(name: str, source: Path, flags=NVCC_FLAGS) -> Path:
    """Where the library of ``source`` built with ``flags`` lives."""
    h = hashlib.sha256()
    h.update(source.read_bytes())
    for dep in local_includes(source):
        h.update(dep.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(nvcc_path().encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, source: Path, flags=NVCC_FLAGS) -> Path:
    """Compile ``source`` unless its library already exists; returns the
    library path.  Raises with nvcc's output when the build fails."""
    out = library_path(name, source, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *flags, "-Xptxas", "-v", "-o", tmp,
               str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        (out.with_suffix(".log")).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str, source: Path, flags=NVCC_FLAGS) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    return ctypes.CDLL(str(build(name, source, flags)))
