"""Build the CUDA kernels in drivescenegen_torch/csrc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, the shared headers
(`csrc/*.cuh`, e.g. hopper.cuh with the TMA/mbarrier/wgmma wrappers) and
the flags, so an edited source or header is rebuilt at its first use and
an unchanged one never is. Every nvcc runs at once when several
libraries are missing. The build directory,
drivescenegen_torch/build/, is listed in .gitignore.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SOURCES = ("gn_silu_conv", "group_norm", "flash_attention", "flash_attention_d8",
           "flash_attention_bwd", "flash_attention_bwd_d8")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's nvcc")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source whose library is missing, all nvcc
    processes started together. Returns {name: {"seconds", "ptxas"}} for
    the ones built. Raises with nvcc's output if one fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def source_int(name: str, constant: str, required: bool = True):
    """The value of the line `constexpr int <constant> = <integer>;` in
    csrc/<name>.cu (None when the source has no such line and `required` is
    False). The wrappers read a kernel's shape limits here, so that they
    check the values the C entry point checks, with no copy of them."""
    src = (CSRC_DIR / f"{name}.cu").read_text()
    found = re.findall(rf"^constexpr int {constant} = (\d+);", src, re.MULTILINE)
    if not found and not required:
        return None
    if len(found) != 1:
        raise RuntimeError(f"csrc/{name}.cu has {len(found)} lines 'constexpr int {constant} = N;'")
    return int(found[0])


def sass_must_hold(name: str) -> tuple:
    """The SASS instructions that csrc/<name>.cu states its library must
    contain, from its line `// SASS must hold: OP OP ...` (HGMMA and
    UTMALDG for a wgmma kernel fed by TMA; an opcode may carry its
    modifiers, as in LDG.E.128)."""
    src = (CSRC_DIR / f"{name}.cu").read_text()
    found = re.findall(r"^// SASS must hold: ([A-Z0-9. ]+)$", src, re.MULTILINE)
    if len(found) != 1:
        raise RuntimeError(f"csrc/{name}.cu has {len(found)} lines '// SASS must hold: ...'")
    return tuple(found[0].split())


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a cudaError_t other than 0."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
