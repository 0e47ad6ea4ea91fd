"""Build the hand-written CUDA kernels with nvcc, and the host C++ sources
with the host compiler, and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher and compiles alone into
``_build/<name>-<key>.so`` at first use; the key covers the source, the
flags and the platform, and a digest beside each library is checked before
it is loaded (:class:`BuildDir`), so an edited source, another toolchain or
card, or a corrupt file rebuilds.  A host source (the JPEG codec,
``harness/csrc/jpeg_codec.cpp``) builds the same way with ``c++`` into the
same directory (:func:`load_host_library`).  Where libraries go is the
process's library store (:func:`use_dir`): ``kernels/_build/`` unless
``utils.enable_compilation_cache`` or ``utils.exec_cache`` moves it.  A
fresh process finds there what an earlier one built, so the builds are
paid once a directory, not once a process.  Nothing here runs at import:
the CPU tests import every module of the package on a machine without
nvcc.  There is no fallback: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Iterator, List

__all__ = ["load_library", "load_host_library", "build_all", "build_sources",
           "KERNEL_SOURCES", "on_device", "count_launch", "BuildDir",
           "use_store", "use_dir", "library_store", "fingerprint"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNEL_SOURCES = ("block_histogram", "descent_step", "masked_histogram",
                  "slab_sampling", "splat_hist")

# -fmad=false: no multiply-add contraction, so each sample's arithmetic
# rounds exactly like the plain PyTorch version's separate mul and add
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

DIGEST = ".sha256"


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


@functools.cache
def fingerprint(cuda: bool) -> str:
    """What a library is built for beyond its source and flags, as the JAX
    package keys a compiled program on its platform: for a CUDA library the
    torch and CUDA versions, ``nvcc``'s version and the card's name; for a
    host library the compiler's version and the machine."""
    if cuda:
        import torch

        return ";".join((f"torch={torch.__version__}",
                         f"cuda={torch.version.cuda}",
                         f"nvcc={_version(_nvcc())}",
                         f"card={torch.cuda.get_device_name()}"))
    return ";".join((f"cxx={_version(_host_compiler())}",
                     f"machine={platform.machine()}"))


def _version(exe: str) -> str:
    """A compiler's ``--version`` text."""
    return subprocess.run([exe, "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def _file_digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


class BuildDir:
    """A directory of built libraries: ``<name>-<key>.so`` beside its
    ``.sha256``, the digest of the file's bytes.  The key hashes the
    source, the flags (``sm_90a`` among them) and the platform
    (:func:`fingerprint`), so an edited source, another torch, CUDA,
    ``nvcc`` or card, misses cleanly.  A library whose bytes do not match
    its digest (a write cut short, a corrupt file, a digest lost) is built
    again and moved over it, never unlinked, so a process loading the old
    file keeps it.  ``hits``, ``built_names`` and ``rebuilt`` name the
    libraries this store found good, built on a miss, and built again over
    a bad one."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        self.hits: List[str] = []
        self.built_names: List[str] = []
        self.rebuilt: List[str] = []

    def target(self, src: Path, flags) -> Path:
        h = hashlib.sha256(src.read_bytes())
        h.update(" ".join(flags).encode())
        h.update(fingerprint(src.suffix == ".cu").encode())
        return self.path / f"{src.stem}-{h.hexdigest()[:32]}.so"

    def ready(self, target: Path) -> bool:
        """Whether ``target`` is there and matches its digest."""
        if not target.exists():
            return False
        try:
            ok = (Path(str(target) + DIGEST).read_text().strip()
                  == _file_digest(target))
        except OSError:
            ok = False
        if not ok:
            self.rebuilt.append(target.name)
            return False
        try:
            os.utime(target)  # the touch exec_cache.evict_lru orders by
        except OSError:
            pass
        self.hits.append(target.name)
        return True

    def built(self, target: Path) -> None:
        """Called once the compiler has written ``target``: its digest."""
        fd, tmp = tempfile.mkstemp(dir=target.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(_file_digest(target))
            os.replace(tmp, str(target) + DIGEST)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        if target.name not in self.rebuilt:
            self.built_names.append(target.name)


# the process's library store: every load and build of this process goes
# through it, as the JAX package's compilation cache is process-wide
_STORE = [BuildDir(BUILD_DIR)]


def use_store(store: BuildDir) -> None:
    """Build and find libraries in ``store`` from now on.  A library this
    process loaded already stays loaded."""
    _STORE[0] = store


def use_dir(path) -> BuildDir:
    """Point the library store at the directory ``path`` (created), unless
    it is there already; returns the store."""
    path = Path(os.path.expanduser(str(path))).resolve()
    path.mkdir(parents=True, exist_ok=True)
    if _STORE[0].path != path:
        _STORE[0] = BuildDir(path)
    return _STORE[0]


def library_store() -> BuildDir:
    return _STORE[0]


def _target(src: Path, flags) -> Path:
    return _STORE[0].target(src, flags)


def _start_build(src: Path, compiler=None, flags=NVCC_FLAGS):
    """Start the compiler (nvcc by default) for one source; returns (target,
    tmp path, process) or None when the library is already built."""
    store = _STORE[0]
    target = store.target(src, flags)
    if store.ready(target):
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [compiler or _nvcc(), *flags, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc, store


def _finish_build(src: Path, target: Path, tmp: str, proc, store) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"the build of {src.name} failed:\n{out}")
    os.replace(tmp, target)
    store.built(target)


def build_sources(jobs) -> None:
    """Build every ``(source, compiler, flags)`` of ``jobs`` that its store
    lacks: one compiler process each (``None``: nvcc), all started
    together."""
    started = [(src, _start_build(src, compiler, flags))
               for src, compiler, flags in jobs]
    for src, job in started:
        if job is not None:
            _finish_build(src, *job)


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Build every named source, one nvcc each, all started together."""
    srcs = {n: CSRC / f"{n}.cu" for n in names}
    build_sources([(src, None, NVCC_FLAGS) for src in srcs.values()])
    return {n: _target(src, NVCC_FLAGS) for n, src in srcs.items()}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first when needed."""
    target = build_all([name])[name]
    return ctypes.CDLL(str(target))


def host_job(src: Path):
    """The ``build_sources`` job of a host C++ source."""
    return Path(src), _host_compiler(), HOST_FLAGS


@functools.cache
def load_host_library(src: Path) -> ctypes.CDLL:
    """The loaded host library built from the C++ source ``src``."""
    src = Path(src)
    build_sources([host_job(src)])
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
