"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, which the kernel modules load
through ``ctypes``.  Nothing here includes PyTorch's headers, so a build
takes seconds.  Libraries land in ``build/kernels/`` at the repository
root, named by a digest of the source, the headers of ``csrc/`` it
includes and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.  Sources build in
parallel, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

# the devices whose tensors a wrapper hands to its kernel's plain version:
# the CPU's, and meta tensors (shapes only: the dry run, launch/dryrun.py);
# on a CUDA tensor it launches the kernel, on any other it raises
PLAIN_DEVICES = ("cpu", "meta")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {
    "fused_rmsnorm": "fused_rmsnorm.cu",
    "flash_attention": "flash_attention.cu",
    "ar_rmsnorm": "ar_rmsnorm.cu",
    "ar_rmsnorm_peer": "ar_rmsnorm_peer.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per source: K3's wgmma body needs ptxas to spend registers on keeping its
# wgmma groups in flight, or it serializes them (warning C7512); the
# one-card K1 instantiates its kernels for every rank count and group size,
# and nvcc optimizes them on 4 threads.  (The cross-rank K1 built that way
# ran slower at N 2 in a trial, so it builds on one.)
EXTRA_FLAGS = {"flash_attention": ("-Xptxas", "--register-usage-level=10"),
               "ar_rmsnorm": ("-split-compile=4",)}

_INCLUDE = re.compile(r'\s*#\s*include\s+"([^"]+)"')

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def flags(name: str) -> tuple:
    """nvcc's flags for one source."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def includes(path: Path) -> list:
    """The headers of ``csrc/`` that a source includes (``#include
    "..."``), with theirs, each once, in the order first met."""
    found, todo = [], [path]
    while todo:
        for line in todo.pop(0).read_text().splitlines():
            m = _INCLUDE.match(line)
            if m and (CSRC / m.group(1)) not in found:
                found.append(CSRC / m.group(1))
                todo.append(CSRC / m.group(1))
    return found


def lib_path(name: str) -> Path:
    """The library of one source, named by a digest of the source, the
    headers it includes and nvcc's flags."""
    src = CSRC / SOURCES[name]
    text = b"".join(p.read_bytes() for p in [src, *includes(src)])
    digest = hashlib.sha256(text + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, object]:
    """Compile every named source whose library is missing, all at once.

    Returns ``{"seconds": wall time, "built": [names], "ptxas": {name:
    nvcc's resource report}, "done_at": {name: seconds from the start
    until its nvcc was seen done}}``; raises with nvcc's output on
    failure."""
    names = list(SOURCES if names is None else names)
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed, seconds = {}, [], {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        seconds[name] = time.perf_counter() - t0   # at least its own time
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs),
            "ptxas": reports, "done_at": seconds}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check_status(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code (every entry
    point returns ``cudaGetLastError()`` right after its launch)."""
    if rc != 0:
        msg = lib.error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
