"""Bucket-hash membership lookup: the CUDA kernel, its wrapper and its plain
version.

``hash_lookup(tab, q_lo, q_hi)`` answers, for each query key (q_lo, q_hi)
(the key's two 32-bit words as int32 bits; ``q_hi=None`` for one-word keys,
whose high word is 0),
whether it is an entry of the planar bucket table ``tab`` that
``PauliEngine._hash_build`` writes, and with which amplitude -- what the JAX
package's Pallas kernel ``ops/pallas_kernels.py`` ``hash_lookup`` computes
(``PauliEngine._proxy_via_hash``, ``lookup_kernel='pallas'``, W <= 2, 32
entries per bucket). The query's bucket is ``mix2(lo, hi) & (nb - 1)``; its
row holds 32 entries in four planar lane ranges, [0, 32) key_lo, [32, 64)
key_hi (both the uint32 bits of the key words, stored as float32), [64, 96)
log|psi| (NEG = empty) and [96, 128) phase. Returns (log|psi| or NEG,
phase or 0, found) per query; on a match of several entries (a duplicate
key, which a unique sample set never holds) the first entry wins.

On a CUDA tensor it launches ``csrc/hash_lookup.cu`` or raises; on a CPU
tensor it runs ``hash_lookup_plain``. It counts its launches in
``hash_lookup.launches``. The lookup is a gather and a select with no
arithmetic on the values, so kernel and plain version agree bit for bit.

The kernel decides most misses from a one-byte tag a slot, which
``hash_tags`` (a kernel of the same source, counted in
``hash_tags.launches``) builds from the table at every ``hash_lookup``
call: the top byte of the slot key's ``mix2`` moved into 1..255, and 0 for
an empty slot (``hash_tags_plain``). The tags only decide which slots the
kernel reads, never the result.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .bits import MASK32

NEG = -1e30
ENTRIES = 32  # per bucket row: 4 planar fields x 32 lanes = 128 floats
ROW = 4 * ENTRIES
# Queries per pass of the plain version: bounds its (chunk, 128) row
# gather at 2 GB (the JAX engine's default ``lookup_chunk``).
PLAIN_CHUNK = 1 << 22


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for int64 ``a`` in [0, 2^32) and a uint32
    constant ``c``, without a signed int64 overflow: the product is split
    at 16 bits of ``c``, so no partial product reaches 2^49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix2(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Three-round avalanche mix of two uint32 words held in int64, bit for
    bit the JAX package's ``PauliEngine._mix2`` in wrapping uint32."""
    acc = mul32(lo, 2654435761)
    acc = acc ^ (acc >> 15)
    acc = mul32(acc ^ hi, 2654435761)
    acc = acc ^ (acc >> 15)
    acc = mul32(acc, 2246822519)
    return acc ^ (acc >> 13)


def as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def tag_of(h: torch.Tensor) -> torch.Tensor:
    """The tag of keys whose ``mix2`` is ``h`` (int64 in [0, 2^32)): the
    top byte, with 0 (the empty-slot tag) moved to 1."""
    t = h >> 24
    return torch.where(t == 0, 1, t)


def hash_tags_plain(tab):
    """(nb, 128) bucket table -> (nb, 32) uint8 tags: each live slot's
    ``tag_of(mix2(key_lo, key_hi))``, 0 for each slot whose log|psi| is not
    above 0.5 NEG (what the lookup counts as empty)."""
    bits = tab.view(torch.int32).to(torch.int64) & MASK32
    tags = tag_of(mix2(bits[:, :ENTRIES], bits[:, ENTRIES:2 * ENTRIES]))
    live = tab[:, 2 * ENTRIES:3 * ENTRIES] > 0.5 * NEG
    return torch.where(live, tags, 0).to(torch.uint8)


def hash_lookup_plain(tab, q_lo, q_hi=None):
    """Torch transcription of the JAX ``_hash_lookup_kernel``: gather each
    query's bucket row, compare the key lanes as int32 bits (a key whose
    bits read as a float NaN still matches), select the first matching
    entry's amplitude lanes."""
    if q_hi is None:
        q_hi = torch.zeros_like(q_lo)
    nb = tab.shape[0]
    bits = tab.view(torch.int32)
    la_out, ph_out, found_out = [], [], []
    for s in range(0, max(q_lo.shape[0], 1), PLAIN_CHUNK):
        lo = q_lo[s:s + PLAIN_CHUNK]
        hi = q_hi[s:s + PLAIN_CHUNK]
        bucket = mix2(lo.to(torch.int64) & MASK32,
                      hi.to(torch.int64) & MASK32) & (nb - 1)
        rows = bits[bucket]  # (chunk, 128)
        la_e = rows[:, 2 * ENTRIES:3 * ENTRIES].view(torch.float32)
        match = (
            (rows[:, :ENTRIES] == lo[:, None])
            & (rows[:, ENTRIES:2 * ENTRIES] == hi[:, None])
            & (la_e > 0.5 * NEG)
        )
        found = torch.any(match, dim=1)
        first = torch.argmax(match.to(torch.uint8), dim=1, keepdim=True)
        ph_e = rows[:, 3 * ENTRIES:].view(torch.float32)
        la_out.append(torch.where(found, la_e.gather(1, first)[:, 0], NEG))
        ph_out.append(torch.where(found, ph_e.gather(1, first)[:, 0], 0.0))
        found_out.append(found)
    return torch.cat(la_out), torch.cat(ph_out), torch.cat(found_out)


def _library():
    lib = cuda_build.load("hash_lookup")
    if lib.hash_lookup_launch.argtypes is None:
        lib.hash_tags_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2)
        lib.hash_tags_launch.restype = ctypes.c_int
        lib.hash_lookup_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_longlong, ctypes.c_void_p]
        )
        lib.hash_lookup_launch.restype = ctypes.c_int
        lib.hash_lookup_tag_smem_bytes.argtypes = []
        lib.hash_lookup_tag_smem_bytes.restype = ctypes.c_int
    return lib


def tags_in_shared_memory(n_buckets: int) -> bool:
    """Whether the kernel stages a table of ``n_buckets`` buckets' tags in
    shared memory (else it reads them from global memory)."""
    return n_buckets * ENTRIES <= _library().hash_lookup_tag_smem_bytes()


def _check_table(tab):
    if tab.shape[1:] != (ROW,) or tab.shape[0] & (tab.shape[0] - 1):
        raise ValueError(f"tab: expected (2^k, {ROW}), got "
                         f"{tuple(tab.shape)}")


def hash_tags(tab: torch.Tensor) -> torch.Tensor:
    """(nb, 128) float32 bucket table -> (nb, 32) uint8 slot tags
    (``hash_tags_plain``)."""
    _check_table(tab)
    if tab.device.type == "cpu":
        return hash_tags_plain(tab)
    if tab.device.type != "cuda":
        raise ValueError(f"no kernel for device {tab.device}")
    cuda_build.check_operand("tab", tab, torch.float32, 2, tab.device)
    tags = torch.empty((tab.shape[0], ENTRIES), dtype=torch.uint8,
                       device=tab.device)
    with torch.cuda.device(tab.device):
        rc = _library().hash_tags_launch(
            tab.data_ptr(), tab.shape[0], tags.data_ptr(),
            torch.cuda.current_stream(tab.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"hash_tags_launch failed: cudaError_t {rc}")
    hash_tags.launches += 1
    return tags


def hash_lookup(tab: torch.Tensor, q_lo: torch.Tensor,
                q_hi: torch.Tensor = None):
    """(nb, 128) float32 bucket table, (N,) int32 query words (the keys'
    32-bit words; ``q_hi=None``: all high words 0) -> (log|psi| (N,)
    float32, phase (N,) float32, found (N,) bool)."""
    _check_table(tab)
    if q_hi is not None and q_lo.shape != q_hi.shape:
        raise ValueError(f"query shapes differ: {tuple(q_lo.shape)} vs "
                         f"{tuple(q_hi.shape)}")
    if any(q.dtype != torch.int32 for q in (q_lo, q_hi) if q is not None):
        raise ValueError("queries: expected int32 key words")
    if tab.device.type == "cpu":
        return hash_lookup_plain(tab, q_lo, q_hi)
    if tab.device.type != "cuda":
        raise ValueError(f"no kernel for device {tab.device}")
    dev = tab.device
    cuda_build.check_operand("tab", tab, torch.float32, 2, dev)
    cuda_build.check_operand("q_lo", q_lo, torch.int32, 1, dev)
    if q_hi is not None:
        cuda_build.check_operand("q_hi", q_hi, torch.int32, 1, dev)
    n = q_lo.shape[0]
    la = torch.empty(n, dtype=torch.float32, device=dev)
    ph = torch.empty(n, dtype=torch.float32, device=dev)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return la, ph, found
    tags = hash_tags(tab)
    with torch.cuda.device(dev):
        rc = _library().hash_lookup_launch(
            tab.data_ptr(), tags.data_ptr(), tab.shape[0], q_lo.data_ptr(),
            None if q_hi is None else q_hi.data_ptr(),
            la.data_ptr(), ph.data_ptr(), found.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"hash_lookup_launch failed: cudaError_t {rc}")
    hash_lookup.launches += 1
    return la, ph, found


hash_tags.launches = 0
hash_lookup.launches = 0
