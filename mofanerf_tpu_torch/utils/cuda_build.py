"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (`sm_90a`) into a shared
library with a plain C interface, `build/<name>-<source hash>.so` beside the
package. The hash covers the source and every file of `csrc/` it includes
(`#include "..."`, followed through). A library already built from the same
sources is reused; a changed source or header builds anew. The kernels use
the CUDA runtime and inline PTX only: nothing links libcuda, no third-party
header. Nothing here runs at import time.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict = {}
# ptxas report (registers, shared memory, spills) of each library built in
# this process, keyed by source name
BUILD_LOG: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{CSRC}/*.cu (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list:
    """csrc/<name>.cu and every file of csrc/ it includes, directly or not, in
    the order found. A quoted include that is not there raises."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        if not path.exists():
            raise RuntimeError(f"{path} is included by a source of {name} but does not exist")
        found.append(path)
        todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())]
    return found


def source_digest(name: str) -> str:
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if not built yet) and return the library path."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(name)
    lib = BUILD_DIR / f"{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_LOG[name] = proc.stdout + proc.stderr
    return lib


def build_all(names=None) -> dict:
    """Build every csrc/*.cu (or `names`) at once, one nvcc each, started
    together. Returns {name: library path}."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
