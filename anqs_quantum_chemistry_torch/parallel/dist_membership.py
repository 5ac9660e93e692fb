"""Bucket-sharded hash membership: table shards and all-to-all query routing.

Counterpart of the JAX package's ``parallel/dist_membership.py``. The
replicated hash membership (``PauliEngine._proxy_via_hash``) builds the whole
(nb, (K + 2) E) bucket table on every device. Here each of the D ranks owns
nb / D contiguous buckets of the same planar layout:

- build: every rank routes its (key, log|psi|, phase) entries to the owner
  of their bucket with one fixed-capacity all-to-all; the owner ranks the
  entries it received within their buckets (a stable sort, in received
  order) and writes its (nb / D, (K + 2) E) shard;
- query: each rank's (B / D) x M partner keys go to their owners the same
  way, are answered on the owner's shard by ``ops/hash_lookup.hash_lookup``
  (kernel #2 on the card, its plain version on the CPU), and the answers
  come back with a second all-to-all.

Table memory and lookup work scale 1 / D. The routing capacities are sized
for a uniform hash with a slack factor, as JAX sizes them; an entry or a
query beyond its capacity is dropped and counted, like a bucket overflow,
in the returned overflow count (a dropped query reads as a miss, never as a
wrong answer).

Kernel #2 reduces a query's bucket by its own mask, ``bucket_hash & (nb - 1)``
with nb = nb / D of the shard: for a query routed to its owner that is the
global bucket less ``owner * nb_local``, the owner's row. JAX answers with a
one-row gather that sums the matching entries; the kernel returns the first
match. Both are the same for a unique set, and both answer phase 0 on a miss.
The routing's padding slots are answered and thrown away, as in JAX.

Unlike JAX (whose ``nb_total`` leaves it out, so that the trainer's
escalation cannot clear a bucket overflow), the bucket count honours
``hash_extra_bits``; at 0 the sizing is JAX's to the bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import hash_lookup as hashops
from ..ops.bits import MASK32
from ..ops.keys import rank_in_group
from .mesh import Mesh, all_reduce, all_to_all

NEG = -1e30


def _uint32(cols):
    """int32 key-word columns as uint32 values held in int64."""
    return [c.to(torch.int64) & MASK32 for c in cols]


def _padded(cols):
    """A one-word key's columns with the high word 0 (K = max(W, 2))."""
    if len(cols) == 1:
        return [cols[0], torch.zeros_like(cols[0])]
    return list(cols)


def _check_even_rows(mesh: Optional[Mesh], b_loc: int, device):
    """Raise ``ValueError`` on every rank unless all row blocks are equal
    (JAX's ``assert b % d == 0``)."""
    if mesh is None or mesh.size == 1:
        return
    n = torch.tensor([b_loc, -b_loc], dtype=torch.int64, device=device)
    hi, neg_lo = (int(v) for v in all_reduce(n, mesh, "max"))
    if hi != -neg_lo:
        raise ValueError(f"hash_dist: row blocks of {-neg_lo} to {hi} rows; "
                         f"the set's rows must divide evenly over D = "
                         f"{mesh.size}")


def hash_membership_dist(mesh: Optional[Mesh], words, log_abs, phase, valid,
                         a_words, *, epb: Optional[int] = None,
                         entry_slack: float = 4.0, query_slack: float = 1.5,
                         hash_extra_bits: int = 0):
    """This rank's row block (B / D rows of (W,) int64 words, log|psi|,
    phase, valid) and the (M, W) flip masks -> (la_p, ph_p) (B / D, M)
    partner amplitudes, NEG / 0 on a miss, and the overflow count (entries
    over the send capacity, over a bucket's E, queries over the route
    capacity), summed over the ranks. ``mesh=None``: one shard."""
    d = 1 if mesh is None else mesh.size
    me = 0 if mesh is None else mesh.rank
    b_loc, w = words.shape
    m = a_words.shape[0]
    dev = words.device
    if w > 4:
        raise ValueError("hash_dist membership supports <= 128 qubits")
    if d & (d - 1):
        raise ValueError(f"hash_dist: D = {d} is not a power of two")
    _check_even_rows(mesh, b_loc, dev)
    if epb is None:
        epb = 32 if w <= 2 else 16
    nk = max(w, 2)
    b = b_loc * d
    nb_total = 1 << (max(8, (4 * b // epb - 1).bit_length(), d.bit_length())
                     + hash_extra_bits)
    nb_local = nb_total // d
    shift_local = nb_local.bit_length() - 1
    cap_e = min(b_loc, -(-int(entry_slack * b_loc) // d))
    cap_e = max(8, -(-cap_e // 8) * 8)
    q_n = b_loc * m
    cap_q = min(q_n, int(query_slack * q_n / d))
    cap_q = max(128, -(-cap_q // 128) * 128)

    # ---- build: route entries to the owner of their bucket ----
    w32 = hashops.as_int32(words)
    cols = _padded([w32[:, i] for i in range(w)])
    bucket = hashops.bucket_hash(_uint32(cols)) & (nb_total - 1)
    owner = torch.where(valid, bucket >> shift_local, d)
    rank = rank_in_group(owner)
    send_ovf_e = valid & (rank >= cap_e)
    slot = torch.where(valid & ~send_ovf_e, owner * cap_e + rank, d * cap_e)
    neg_bits = int(torch.tensor(NEG, dtype=torch.float32).view(torch.int32))
    buf = torch.zeros((d * cap_e + 1, nk + 2), dtype=torch.int32, device=dev)
    buf[:, nk] = neg_bits
    buf[slot] = torch.stack(cols + [
        torch.where(valid, log_abs, NEG).to(torch.float32).view(torch.int32),
        phase.to(torch.float32).view(torch.int32)], dim=1)
    recv = all_to_all(buf[:d * cap_e], mesh)

    # The owner's (nb_local, (K + 2) E) planar shard, entries ranked within
    # their bucket in received order (rank order of the senders, then row
    # order: the global row order).
    r_cols = [recv[:, i] for i in range(nk)]
    r_la = recv[:, nk].contiguous().view(torch.float32)
    r_valid = r_la > 0.5 * NEG
    r_bucket = hashops.bucket_hash(_uint32(r_cols)) & (nb_total - 1)
    loc = torch.where(r_valid, r_bucket - me * nb_local, nb_local)
    rank2 = rank_in_group(loc)
    ovf_b = r_valid & (rank2 >= epb)
    ok = r_valid & ~ovf_b
    row = torch.where(ok, loc, nb_local)
    lane = torch.where(ok, rank2, 0)
    tab = torch.full((nb_local + 1, (nk + 2) * epb), neg_bits,
                     dtype=torch.int32, device=dev)
    for i in range(nk + 2):
        tab[row, lane + i * epb] = recv[:, i]
    tab = tab[:nb_local].view(torch.float32)

    # ---- query: route the partner keys x ^ A_m to their owners ----
    a32 = hashops.as_int32(a_words)
    q_cols = _padded([(w32[:, None, i] ^ a32[None, :, i]).reshape(-1)
                      for i in range(w)])
    q_bucket = hashops.bucket_hash(_uint32(q_cols)) & (nb_total - 1)
    owner_q = q_bucket >> shift_local
    rank_q = rank_in_group(owner_q)
    ovf_q = rank_q >= cap_q
    slot_q = torch.where(ovf_q, d * cap_q, owner_q * cap_q + rank_q)
    qbuf = torch.zeros((d * cap_q + 1, nk), dtype=torch.int32, device=dev)
    qbuf[slot_q] = torch.stack(q_cols, dim=1)
    rq = all_to_all(qbuf[:d * cap_q], mesh)

    # One lookup over all D * cap_q routed queries: kernel #2 gathers no
    # (queries, (K + 2) E) rows, so JAX's ``lookup_chunk`` has no
    # counterpart (the plain version chunks on its own).
    n_q = d * cap_q
    la, ph, _ = hashops.hash_lookup(
        tab, *[rq[:, i].contiguous() for i in range(nk)], entries=epb)
    back = all_to_all(torch.stack([la, ph], dim=1), mesh)

    safe = torch.clamp(slot_q, max=n_q - 1)
    la_p = torch.where(ovf_q, NEG, back[safe, 0])
    ph_p = torch.where(ovf_q, 0.0, back[safe, 1])
    overflow = all_reduce(
        (torch.sum(send_ovf_e) + torch.sum(ovf_b) + torch.sum(ovf_q)).to(
            torch.int64), mesh)
    return la_p.reshape(b_loc, m), ph_p.reshape(b_loc, m), overflow
