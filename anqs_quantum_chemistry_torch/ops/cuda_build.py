"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain ``extern "C"`` functions and is
compiled on its own into ``_build/lib<name>_<hash>.so`` (``_build/`` sits
beside ``csrc/`` and is listed in ``.gitignore``). The hash covers the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as built. Nothing here includes PyTorch's headers: a source with a
plain C interface builds in seconds, where ``torch.utils.cpp_extension``
takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the port's CUDA kernels are built on the machine with the card"
        )
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists;
    returns (process or None, library path, temporary output path)."""
    out = library_path(name)
    if os.path.exists(out):
        return None, out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def build(names: Iterable[str], timeout: float = 600.0) -> Dict[str, str]:
    """Compile the given sources, one ``nvcc`` each, all started together.
    Returns {name: compiler output} for the sources that were compiled."""
    jobs = {name: _start_build(name) for name in names}
    logs = {}
    try:
        for name, (proc, out, tmp) in jobs.items():
            if proc is None:
                continue
            log, _ = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)
            logs[name] = log
    finally:
        for proc, _, tmp in jobs.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp is not None and os.path.exists(tmp):
                os.remove(tmp)
    return logs


def check_operand(name, t, dtype, ndim, device):
    """Raise ``ValueError`` unless ``t`` is a contiguous ``ndim``-d tensor
    of ``dtype`` on ``device``: what a kernel launcher takes."""
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(
            f"{name}: expected {ndim}-d {dtype} on {device}, got "
            f"{t.dim()}-d {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(library_path(name))
    return _loaded[name]
