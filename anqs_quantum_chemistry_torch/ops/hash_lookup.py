"""Bucket-hash membership lookup: the CUDA kernel, its wrapper and its plain
version.

``hash_lookup(tab, *q_cols, entries=32)`` answers, for each query key (its
K = max(W, 2) 32-bit words as int32 bits, one column each; the high word
of one-word keys, which is 0, given as None or left off),
whether it is an entry of the planar bucket table ``tab`` that
``PauliEngine._hash_build`` writes, and with which amplitude -- what the JAX
package's Pallas kernel ``ops/pallas_kernels.py`` ``hash_lookup`` computes
(``PauliEngine._proxy_via_hash``, ``lookup_kernel='pallas'``, W <= 2, 32
entries per bucket), and at the other layouts what the JAX engine's
``_hash_query`` computes (``hash_epb`` rows at W <= 2, 16-entry rows at W
3-4). The query's bucket is ``bucket_hash`` of its words (``mix2(k0, k1)``
folded left over the others) ``& (nb - 1)``; its row holds E = ``entries``
entries in K + 2 planar lane ranges of E lanes: the K key words (the uint32
bits, stored as float32), log|psi| (NEG = empty) and phase. ``LAYOUTS``
lists the (K, E) pairs. Returns (log|psi| or NEG, phase or 0, found) per
query; on a match of several entries (a duplicate key, which a unique
sample set never holds) the first entry wins.

On a CUDA tensor it launches ``csrc/hash_lookup.cu`` or raises; on a CPU
tensor it runs ``hash_lookup_plain``. It counts its launches in
``hash_lookup.launches``. The lookup is a gather and a select with no
arithmetic on the values, so kernel and plain version agree bit for bit.

The kernel decides most misses from a one-byte tag a slot, which
``hash_tags`` (a kernel of the same source, counted in
``hash_tags.launches``) builds from the table at every ``hash_lookup``
call: the top byte of the slot key's ``bucket_hash`` moved into 1..255,
and 0 for an empty slot (``hash_tags_plain``). The tags only decide which
slots the kernel reads, never the result.

``fp_filter(fptab, words, a_cols)`` is the prefilter's stage 1 (kernel
#3, ``fp_filter_kernel`` of the same source): for rows ``words`` (B, W)
and group masks ``a_cols`` (W, M), whether some slot of the bucket of each
partner x ^ A_m in the (nb, E) fingerprint table holds the partner's
``fp_hash`` -- a (B, M) bool mask, bit for bit ``fp_filter_plain``. It
counts its launches in ``fp_filter.launches``, runs inside the span
``fp_filter`` with the counters ``fp_launches`` and ``fp_smem_launches``
(calls whose table fits ``FP_SMEM_BYTES``, which the kernel stages in
shared memory; the others it probes in global memory). Its partners are
the enclosing ``pf.stage1``'s ``partners``.

All three report their work to an active ``utils.cost.WorkCounter``
(``lookup_work``, ``tags_work``, ``filter_work``: bytes alone, the
integer hashing counting no flops) whichever implementation runs; a lookup
of at least one query reports the tag build it needs on the card on the
CPU too. ``hash_lookup`` runs inside ``utils/spans.py``'s span
``hash_lookup``, whose counters give each launch's shape, on the card and
on the CPU alike: ``launches``, ``queries``, ``key_words`` (the query
words given), ``buckets``, ``entries`` (buckets x entries a bucket) and
``table_words`` (the table's 32-bit words, buckets x (K + 2) E).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cost, spans
from . import cuda_build
from .bits import MASK32

NEG = -1e30
ENTRIES = 32  # per bucket row of the Pallas layout: 4 fields x 32 lanes
ROW = 4 * ENTRIES
# The (key words K, entries a bucket E) of the tables the kernel reads: the
# JAX engine's rows at W <= 2 (E 32, or ``hash_epb`` 8 or 16) and at W 3-4.
LAYOUTS = ((2, 32), (2, 16), (2, 8), (3, 16), (4, 16))
# Queries per pass of the plain version: bounds its (chunk, 128) row
# gather at 2 GB (the JAX engine's default ``lookup_chunk``).
PLAIN_CHUNK = 1 << 22
# Partners a pass of ``fp_filter_plain``: bounds its int64 (chunk,)
# temporaries at 64 MB each.
FP_QUERY_CHUNK = 1 << 23
# Bytes of fingerprint table (nb x E x 4) up to which kernel #3 stages the
# table in shared memory (Cr2: nb 512 x E 16 = 32 KB); above, its probes
# read global memory (L2).
FP_SMEM_BYTES = 64 * 1024


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


def bucket_hash(cols) -> torch.Tensor:
    """The bucket hash of keys given as a sequence of K >= 2 uint32 word
    columns held in int64: ``mix2`` of the first two, folded left over the
    others (JAX ``PauliEngine._bucket_hash``)."""
    acc = mix2(cols[0], cols[1])
    for c in cols[2:]:
        acc = mix2(acc, c)
    return acc


def fp32(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """32-bit key fingerprint of two uint32 words held in int64, bit for
    bit the JAX package's ``PauliEngine._fp32`` (constants distinct from
    the bucket hash); never 0, the empty-slot value."""
    acc = mul32(lo, 0x9E3779B1)
    acc = acc ^ (acc >> 16)
    acc = mul32(acc ^ hi, 0x85EBCA77)
    acc = acc ^ (acc >> 13)
    acc = mul32(acc, 0xC2B2AE3D)
    acc = acc ^ (acc >> 16)
    return acc | 1


def fp_hash(cols) -> torch.Tensor:
    """The fingerprint of keys given as K >= 2 uint32 word columns held in
    int64: ``fp32`` of the first two, folded left over the others (JAX
    ``PauliEngine._fp_hash``)."""
    acc = fp32(cols[0], cols[1])
    for c in cols[2:]:
        acc = fp32(acc, c)
    return acc


def as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def tag_of(h: torch.Tensor) -> torch.Tensor:
    """The tag of keys whose ``bucket_hash`` is ``h`` (int64 in [0, 2^32)):
    the top byte, with 0 (the empty-slot tag) moved to 1."""
    t = h >> 24
    return torch.where(t == 0, 1, t)


def key_words(tab, entries: int = ENTRIES) -> int:
    """K, the key words of a bucket table of ``entries`` entries a bucket
    (its rows are (K + 2) * entries lanes). Raises ``ValueError`` on a shape
    that is no layout of ``LAYOUTS`` or a bucket count that is not a power
    of two."""
    nb, row = tab.shape if tab.dim() == 2 else (0, 0)
    k = row // entries - 2 if row % entries == 0 else 0
    if (k, entries) not in LAYOUTS or nb < 1 or nb & (nb - 1):
        raise ValueError(
            f"tab: expected (2^k, (K + 2) * {entries}) with (K, E) in "
            f"{LAYOUTS}, got {tuple(tab.shape)}")
    return k


def _columns(q_cols, k: int):
    """The query columns padded with None to K; raises ``ValueError``
    unless every column is given but the high word at K = 2, or on
    differing shapes or non-int32 words."""
    cols = tuple(q_cols) + (None,) * (k - len(q_cols))
    if len(cols) != k or any(q is None for q in cols[:1] + cols[2:]):
        raise ValueError(f"queries: expected {k} key-word columns (the "
                         "second may be None at 2)")
    given = [q for q in cols if q is not None]
    if any(q.shape != given[0].shape for q in given):
        raise ValueError("query shapes differ: "
                         f"{[tuple(q.shape) for q in given]}")
    if any(q.dtype != torch.int32 for q in given):
        raise ValueError("queries: expected int32 key words")
    return cols


def hash_tags_plain(tab, entries: int = ENTRIES):
    """(nb, (K + 2) E) bucket table -> (nb, E) uint8 tags: each live slot's
    ``tag_of(bucket_hash(its key words))``, 0 for each slot whose log|psi|
    is not above 0.5 NEG (what the lookup counts as empty)."""
    k = key_words(tab, entries)
    bits = tab.view(torch.int32).to(torch.int64) & MASK32
    tags = tag_of(bucket_hash([bits[:, j * entries:(j + 1) * entries]
                               for j in range(k)]))
    live = tab[:, k * entries:(k + 1) * entries] > 0.5 * NEG
    return torch.where(live, tags, 0).to(torch.uint8)


def hash_lookup_plain(tab, *q_cols, entries: int = ENTRIES):
    """Torch transcription of the JAX ``_hash_lookup_kernel`` (and of
    ``_hash_query`` at the other layouts): gather each query's bucket row,
    compare the key lanes as int32 bits (a key whose bits read as a float
    NaN still matches), select the first matching entry's amplitude
    lanes."""
    k = key_words(tab, entries)
    cols = _columns(q_cols, k)
    cols = tuple(torch.zeros_like(cols[0]) if q is None else q for q in cols)
    e = entries
    nb = tab.shape[0]
    bits = tab.view(torch.int32)
    la_out, ph_out, found_out = [], [], []
    for s in range(0, max(cols[0].shape[0], 1), PLAIN_CHUNK):
        qs = [q[s:s + PLAIN_CHUNK] for q in cols]
        bucket = bucket_hash([q.to(torch.int64) & MASK32 for q in qs]) & (
            nb - 1)
        rows = bits[bucket]  # (chunk, (K + 2) E)
        la_e = rows[:, k * e:(k + 1) * e].view(torch.float32)
        match = la_e > 0.5 * NEG
        for j, q in enumerate(qs):
            match = match & (rows[:, j * e:(j + 1) * e] == q[:, None])
        found = torch.any(match, dim=1)
        first = torch.argmax(match.to(torch.uint8), dim=1, keepdim=True)
        ph_e = rows[:, (k + 1) * e:].view(torch.float32)
        la_out.append(torch.where(found, la_e.gather(1, first)[:, 0], NEG))
        ph_out.append(torch.where(found, ph_e.gather(1, first)[:, 0], 0.0))
        found_out.append(found)
    return torch.cat(la_out), torch.cat(ph_out), torch.cat(found_out)


def _library():
    lib = cuda_build.load("hash_lookup")
    if lib.hash_lookup_launch.argtypes is None:
        lib.hash_tags_launch.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        lib.hash_tags_launch.restype = ctypes.c_int
        lib.hash_lookup_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p]
        )
        lib.hash_lookup_launch.restype = ctypes.c_int
        lib.hash_lookup_tag_smem_bytes.argtypes = []
        lib.hash_lookup_tag_smem_bytes.restype = ctypes.c_int
        lib.fp_filter_launch.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 2
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        lib.fp_filter_launch.restype = ctypes.c_int
    return lib


def tags_in_shared_memory(n_buckets: int, entries: int = ENTRIES) -> bool:
    """Whether the kernel stages the tags of a table of ``n_buckets``
    buckets of ``entries`` entries in shared memory (else it reads them
    from global memory)."""
    n_bytes = n_buckets * entries
    return (n_bytes <= _library().hash_lookup_tag_smem_bytes()
            and n_bytes % 16 == 0)


def tags_work(tab: torch.Tensor, entries: int = ENTRIES) -> int:
    """Bytes of a tag build: the table read and the (nb, E) tags written
    once (no flops)."""
    return tab.numel() * 4 + tab.shape[0] * entries


def lookup_work(tab: torch.Tensor, cols, entries: int = ENTRIES) -> int:
    """Bytes of a lookup, as the kernel table's bound counts them: 4 B a
    given query word, the table and its tags read once, 9 B of output a
    query (no flops)."""
    n = cols[0].shape[0]
    given = sum(q is not None for q in cols)
    return 4 * n * given + tab.numel() * 4 + tab.shape[0] * entries + 9 * n


def hash_tags(tab: torch.Tensor, entries: int = ENTRIES) -> torch.Tensor:
    """(nb, (K + 2) E) float32 bucket table -> (nb, E) uint8 slot tags
    (``hash_tags_plain``)."""
    k = key_words(tab, entries)
    cost.report("hash_tags", bytes_accessed=tags_work(tab, entries))
    with cost.suspended():
        return _hash_tags(tab, k, entries)


def _hash_tags(tab, k, entries):
    if tab.device.type == "cpu":
        return hash_tags_plain(tab, entries)
    if tab.device.type != "cuda":
        raise ValueError(f"no kernel for device {tab.device}")
    cuda_build.check_operand("tab", tab, torch.float32, 2, tab.device)
    tags = torch.empty((tab.shape[0], entries), dtype=torch.uint8,
                       device=tab.device)
    with torch.cuda.device(tab.device):
        rc = _library().hash_tags_launch(
            tab.data_ptr(), tab.shape[0], k, entries, tags.data_ptr(),
            torch.cuda.current_stream(tab.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"hash_tags_launch failed: cudaError_t {rc}")
    hash_tags.launches += 1
    return tags


def hash_lookup(tab: torch.Tensor, *q_cols, entries: int = ENTRIES):
    """(nb, (K + 2) E) float32 bucket table, K (N,) int32 query word
    columns (at K = 2 the second None or left off: one-word keys) ->
    (log|psi| (N,) float32, phase (N,) float32, found (N,) bool)."""
    k = key_words(tab, entries)
    cols = _columns(q_cols, k)
    n = cols[0].shape[0]
    with spans.span("hash_lookup"):
        if n:
            cost.report("hash_tags", bytes_accessed=tags_work(tab, entries))
            cost.report("hash_lookup",
                        bytes_accessed=lookup_work(tab, cols, entries))
            nb = tab.shape[0]
            for name, value in (
                    ("launches", 1), ("queries", n),
                    ("key_words", n * sum(q is not None for q in cols)),
                    ("buckets", nb), ("entries", nb * entries),
                    ("table_words", tab.numel())):
                spans.count(name, value)
        with cost.suspended():
            return _hash_lookup(tab, cols, k, entries)


def _hash_lookup(tab, cols, k, entries):
    if tab.device.type == "cpu":
        return hash_lookup_plain(tab, *cols, entries=entries)
    if tab.device.type != "cuda":
        raise ValueError(f"no kernel for device {tab.device}")
    dev = tab.device
    cuda_build.check_operand("tab", tab, torch.float32, 2, dev)
    for j, q in enumerate(cols):
        if q is not None:
            cuda_build.check_operand(f"q_cols[{j}]", q, torch.int32, 1, dev)
    n = cols[0].shape[0]
    la = torch.empty(n, dtype=torch.float32, device=dev)
    ph = torch.empty(n, dtype=torch.float32, device=dev)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return la, ph, found
    tags = _hash_tags(tab, k, entries)
    ptrs = [None if q is None else q.data_ptr() for q in cols]
    ptrs += [None] * (4 - len(ptrs))
    with torch.cuda.device(dev):
        rc = _library().hash_lookup_launch(
            tab.data_ptr(), tags.data_ptr(), tab.shape[0], k, entries,
            *ptrs, la.data_ptr(), ph.data_ptr(), found.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"hash_lookup_launch failed: cudaError_t {rc}")
    hash_lookup.launches += 1
    return la, ph, found


def fp_layout(fptab, words, a_cols) -> None:
    """Check ``fp_filter``'s operands: an (nb, E) int32 fingerprint table
    with nb a power of two and (K, E) in ``LAYOUTS``, (B, W) int64 rows
    and (W, M) int32 group masks, K = max(W, 2), the partners' key words.
    Raises ``ValueError`` on anything else."""
    if fptab.dim() != 2 or words.dim() != 2 or a_cols.dim() != 2:
        raise ValueError("fp_filter: expected a 2-d table, rows and masks")
    nb, e = fptab.shape
    w = words.shape[1]
    k = max(w, 2)
    if (k, e) not in LAYOUTS or w > 4 or nb < 1 or nb & (nb - 1):
        raise ValueError(
            f"fp_filter: table {tuple(fptab.shape)} at W {w}: expected "
            f"(2^k, E) with (max(W, 2), E) in {LAYOUTS}")
    if a_cols.shape[0] != w:
        raise ValueError(f"fp_filter: masks {tuple(a_cols.shape)}, "
                         f"expected ({w}, M)")
    if (fptab.dtype, words.dtype, a_cols.dtype) != (
            torch.int32, torch.int64, torch.int32):
        raise ValueError("fp_filter: expected an int32 table, int64 rows "
                         "and int32 masks")


def fp_in_shared_memory(n_buckets: int, entries: int) -> bool:
    """Whether kernel #3 stages a fingerprint table of ``n_buckets`` x
    ``entries`` slots in shared memory (else it probes global memory)."""
    return n_buckets * entries * 4 <= FP_SMEM_BYTES


def filter_work(fptab, words, a_cols) -> int:
    """Bytes of a stage-1 pass: the rows (8 B a word), the masks (4 B a
    word) and the table read once, the (B, M) bool mask written once."""
    return (words.numel() * 8 + a_cols.numel() * 4 + fptab.numel() * 4
            + words.shape[0] * a_cols.shape[1])


def fp_filter_plain(fptab, words, a_cols):
    """The prefilter's stage 1 in plain torch, in passes of about
    ``FP_QUERY_CHUNK`` partners. JAX gathers the bucket's (E,) fingerprint
    row a partner and compares its lanes; here the same question is one
    binary search of the key bucket * 2^32 + fingerprint among the table's
    sorted slot keys (an empty slot's fingerprint, 0, is never a
    partner's), which answers alike without the (chunk, E) gather."""
    fp_layout(fptab, words, a_cols)
    b, w = words.shape
    nb, m = fptab.shape[0], a_cols.shape[1]
    dev = words.device
    slots = ((torch.arange(nb, device=dev)[:, None] << 32)
             | (fptab.to(torch.int64) & MASK32)).reshape(-1)
    slots = torch.sort(slots).values
    a = a_cols.to(torch.int64) & MASK32
    hits = torch.empty((b, m), dtype=torch.bool, device=dev)
    step = max(1, FP_QUERY_CHUNK // max(m, 1))
    for s in range(0, b, step):
        cols = [words[s:s + step, i, None] ^ a[None, i] for i in range(w)]
        if w == 1:
            cols.append(torch.zeros_like(cols[0]))
        key = ((bucket_hash(cols) & (nb - 1)) << 32) | fp_hash(cols)
        pos = torch.clamp(torch.searchsorted(slots, key),
                          max=slots.numel() - 1)
        hits[s:s + step] = slots[pos] == key
    return hits


def fp_filter(fptab: torch.Tensor, words: torch.Tensor,
              a_cols: torch.Tensor) -> torch.Tensor:
    """(nb, E) int32 fingerprint table (``PauliEngine._hash_build``'s, 0 an
    empty slot), (B, W) int64 rows, (W, M) int32 group masks (planar) ->
    (B, M) bool: whether the bucket of x_r ^ A_m holds its fingerprint."""
    fp_layout(fptab, words, a_cols)
    staged = fp_in_shared_memory(*fptab.shape)
    with spans.span("fp_filter"):
        spans.count("fp_launches", 1)
        spans.count("fp_smem_launches", int(staged))
        cost.report("fp_filter",
                    bytes_accessed=filter_work(fptab, words, a_cols))
        with cost.suspended():
            if words.device.type == "cpu":
                return fp_filter_plain(fptab, words, a_cols)
            return _fp_filter(fptab, words, a_cols, staged)


def _fp_filter(fptab, words, a_cols, staged):
    """The launch of kernel #3 on operands that ``fp_layout`` passed: all
    on one CUDA device, contiguous, the table 16-byte aligned."""
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for name, t in (("fptab", fptab), ("words", words), ("a_cols", a_cols)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if fptab.data_ptr() % 16:
        raise ValueError("fptab must be 16-byte aligned")
    (nb, e), (b, w), m = fptab.shape, words.shape, a_cols.shape[1]
    hits = torch.empty((b, m), dtype=torch.bool, device=dev)
    if b == 0 or m == 0:
        return hits
    with torch.cuda.device(dev):
        rc = _library().fp_filter_launch(
            fptab.data_ptr(), nb, e, words.data_ptr(), w, a_cols.data_ptr(),
            b, m, int(staged), hits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fp_filter_launch failed: cudaError_t {rc}")
    fp_filter.launches += 1
    return hits


hash_tags.launches = 0
hash_lookup.launches = 0
fp_filter.launches = 0
