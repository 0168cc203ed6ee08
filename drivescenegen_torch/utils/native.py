"""Builds the repository's native host libraries (native/*.cpp) at first use.

g++ is called directly with the flags of native/Makefile, into
drivescenegen_torch/build/, under a name that carries a hash of the source
and the flags. The compiler writes a temporary file, under an exclusive
fcntl lock on build/<name>.lock, and os.replace moves it to its name, so a
process never loads a half-written library, however many build at once.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def library_path(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """<build_dir>/lib<stem>-<hash of source and flags>.so"""
    digest = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir / f"lib{source.stem}-{digest}.so"


def build(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `source` into build_dir unless its library exists; returns
    the library's path. Raises if there is no compiler or the build fails."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f"{source.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():  # another process may have built it meanwhile
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                                      capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(f"{cxx} exited {proc.returncode}: {proc.stderr[-2000:]}")
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
    return out
