"""Compile-on-first-use build cache for the C++ host components.

Native code exposes a plain C ABI and Python binds it with ``ctypes``. Each
``csrc/<name>.cc`` is compiled with ``g++`` into
``build/torch_native/<name>-<hash>.so`` at the repository root, named by a
hash of the source and its local headers, so an edited source builds anew
and a stale library is never loaded. Nothing is built at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"


def native_available() -> bool:
    return shutil.which("g++") is not None


def build_library(source_name: str) -> str:
    """Compile ``csrc/<source_name>`` to a shared library; return its path.
    Memoized by the hash of the source and every ``csrc/*.h``."""
    src = CSRC / source_name
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.h")):
        h.update(header.read_bytes())
    out = BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    if not native_available():
        raise RuntimeError(f"g++ not found; {source_name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    proc = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic against concurrent builds
    return str(out)
