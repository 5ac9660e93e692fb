"""ctypes bindings of the C++ Slater-Condon builder
(``csrc/slater_condon.cpp``).

The source is compiled with ``g++ -O3 -shared -fPIC`` into
``_build/libslater_condon_<hash>.so`` (``_build/`` sits beside ``csrc/`` and
is listed in ``.gitignore``; the hash covers the source and the flags, as
``ops/cuda_build.py`` keys the CUDA libraries) and loaded with ``ctypes``,
``argtypes`` set. It is host code, as in the JAX package
(``chem/native.py``), which falls back to its Python loop when the build
fails. Here a failed build raises: at the 131,072 determinants of Li2O's
selected-CI target the Python loop (``fci.sparse_hamiltonian_plain``) would
take hours, and a run must not slow down that far without saying so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PACKAGE_DIR, "csrc", "slater_condon.cpp")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libslater_condon_{digest.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """The builder's library, compiled first if needed. Raises
    ``RuntimeError`` when ``g++`` is missing or fails."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not os.path.exists(out):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(
                "g++ not found on PATH: the Slater-Condon builder "
                "(csrc/slater_condon.cpp) cannot be compiled")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on csrc/slater_condon.cpp:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    lib.slater_condon_build.restype = ctypes.c_int64
    lib.slater_condon_build.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int,
        _F64P, _F64P, ctypes.c_double, ctypes.c_int, _I64P, _I64P, _F64P,
    ]
    _lib = lib
    return lib


def sparse_hamiltonian_native(dets, h1, v, tol: float = 1e-14):
    """COO (rows, cols, vals) of H over a strictly ascending uint64
    determinant list: a counting pass, then a filling pass into arrays of
    that size. Elements with |H_ij| <= ``tol`` off the diagonal are
    dropped (JAX ``native.sparse_hamiltonian_native``)."""
    lib = load()
    d = np.ascontiguousarray(dets, dtype=np.uint64)
    h1 = np.ascontiguousarray(h1, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    args = (d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(d),
            h1.shape[0], h1.ctypes.data_as(_F64P), v.ctypes.data_as(_F64P),
            tol)
    nnz = lib.slater_condon_build(*args, 0, _I64P(), _I64P(), _F64P())
    rows = np.empty(nnz, np.int64)
    cols = np.empty(nnz, np.int64)
    vals = np.empty(nnz, np.float64)
    filled = lib.slater_condon_build(
        *args, 1, rows.ctypes.data_as(_I64P), cols.ctypes.data_as(_I64P),
        vals.ctypes.data_as(_F64P))
    if filled != nnz:
        raise RuntimeError(f"slater_condon_build: counted {nnz} elements, "
                           f"filled {filled}")
    return rows, cols, vals
