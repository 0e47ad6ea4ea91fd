"""Build the hand-written CUDA kernels with nvcc, and the host C++ sources
with the host compiler, and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher and compiles alone into
``_build/<name>-<hash>.so`` at first use; the hash covers the source and
the flags, so an edited source rebuilds.  A host source (the JPEG codec,
``harness/csrc/jpeg_codec.cpp``) builds the same way with ``c++`` into the
same directory (:func:`load_host_library`).  Nothing here runs at import:
the CPU tests import every module of the package on a machine without
nvcc.  There is no fallback: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Iterator

__all__ = ["load_library", "load_host_library", "build_all",
           "KERNEL_SOURCES", "on_device", "count_launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNEL_SOURCES = ("block_histogram", "masked_histogram", "slab_sampling")

# -fmad=false: no multiply-add contraction, so each sample's arithmetic
# rounds exactly like the plain PyTorch version's separate mul and add
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


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


def _host_compiler() -> str:
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no C++ compiler (c++, g++ or clang++) on PATH: the port's host "
        "codec is built from source at first use"
    )


def _target(src: Path, flags) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def _start_build(src: Path, compiler=None, flags=NVCC_FLAGS):
    """Start the compiler (nvcc by default) for one source; returns (target,
    tmp path, process) or None when the library is already built."""
    target = _target(src, flags)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler or _nvcc(), *flags, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish_build(src: Path, target: Path, tmp: str, proc) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"the build of {src.name} failed:\n{out}")
    os.replace(tmp, target)


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Build every named source, one nvcc each, all started together."""
    srcs = {n: CSRC / f"{n}.cu" for n in names}
    started = {n: _start_build(src) for n, src in srcs.items()}
    for n, job in started.items():
        if job is not None:
            _finish_build(srcs[n], *job)
    return {n: _target(src, NVCC_FLAGS) for n, src in srcs.items()}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first when needed."""
    target = build_all([name])[name]
    return ctypes.CDLL(str(target))


@functools.cache
def load_host_library(src: Path) -> ctypes.CDLL:
    """The loaded host library built from the C++ source ``src``."""
    src = Path(src)
    job = _start_build(src, _host_compiler(), HOST_FLAGS)
    if job is not None:
        _finish_build(src, *job)
    return ctypes.CDLL(str(_target(src, HOST_FLAGS)))


@contextlib.contextmanager
def on_device(device) -> Iterator[ctypes.c_void_p]:
    """Make ``device`` the current CUDA device for a launch and yield
    PyTorch's current stream there.  A launcher launches on the current
    device, which need not be the device of its tensors (``cuda:1`` while
    ``cuda:0`` is current, or a thread that never chose one)."""
    import torch

    with torch.cuda.device(device):
        yield ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def count_launch(wrapper, device) -> None:
    """Count one launch of ``wrapper``'s kernel: ``wrapper.launches`` in
    all, ``wrapper.by_card`` per card index."""
    wrapper.launches += 1
    wrapper.by_card[device.index] = wrapper.by_card.get(device.index, 0) + 1
