"""Build-at-first-use for the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/torch_kernels/<name>-<hash>.so`` at the repository root,
named by a hash of its source, every ``csrc/*.cuh`` header and the flags (a
changed source or header builds anew, an unchanged one loads the cached
library), then loaded with ``ctypes``. No
PyTorch headers are involved, so a build takes seconds. ``build_all`` starts
one ``nvcc`` per source, all at once. Nothing here runs at import time: the
CPU tests import every module on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# sm_90a: Hopper with its architecture-specific instructions. No
# --use_fast_math: the sampler's expf/logf/division must be the accurate ones.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


@dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    log: str  # nvcc/ptxas output (registers, shared memory, spills); "" if cached


_built: dict[tuple[str, tuple[str, ...]], Built] = {}
_locks: dict[tuple[str, tuple[str, ...]], threading.Lock] = {}
_locks_mu = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels build on the GPU host at first use")
    return found


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def source_digest(name: str, defines: tuple[str, ...] = ()) -> str:
    """The cache key of ``csrc/<name>.cu``: a hash of the source, of every
    header in ``csrc/`` (names and bytes; a source may include any of
    them) and of the flags, ``defines`` (``NAME=value``) among them."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return h.hexdigest()[:16]


def load(name: str, defines: tuple[str, ...] = ()) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu``, with ``-D`` for each
    of ``defines`` (a measurement's variant; the package's own calls pass
    none); cached per process."""
    key = (name, tuple(defines))
    with _locks_mu:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key in _built:
            return _built[key]
        src = CSRC / f"{name}.cu"
        out = BUILD_DIR / f"{name}-{source_digest(name, key[1])}.so"
        log = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run(
                [_nvcc(), *_flags(key[1]), "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        built = Built(ctypes.CDLL(str(out)), log)
        _built[key] = built
        return built


def build_all() -> dict[str, Built]:
    """Build and load every source in ``csrc/``, one ``nvcc`` each, started
    together; raises on the first failed build."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load, names)))
