"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher and compiles alone into
``_build/<name>-<hash>.so`` at first use; the hash covers the source and
the flags, so an edited source rebuilds.  Nothing here runs at import: the
CPU tests import every module of the package on a machine without nvcc.
There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["load_library", "build_all", "KERNEL_SOURCES", "stream_ptr"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNEL_SOURCES = ("block_histogram", "slab_sampling")

# -fmad=false: no multiply-add contraction, so each sample's arithmetic
# rounds exactly like the plain PyTorch version's separate mul and add
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the port's "
        "CUDA kernels are built from source at first use"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (target, tmp path, process) or
    None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish_build(name: str, target: Path, tmp: str, proc) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Build every named source, one nvcc each, all started together."""
    names = list(names)
    started = {n: _start_build(n) for n in names}
    for n, job in started.items():
        if job is not None:
            _finish_build(n, *job)
    return {n: _target(n) for n in names}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first when needed."""
    target = build_all([name])[name]
    return ctypes.CDLL(str(target))


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a launcher."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
