"""The benchmark's own counts of work, from the configuration's shapes and
the rows of the step's inputs, and the card's peaks (``peaks.json``).

A step's flops (matmul class; the shares' numerator) are what the method
needs, whatever implements it. The ansatz's own file
(``ansatze/<net_type>.py``) counts a row's forward and backward and the
sampler's forwards; to those a step adds

- log psi of the set, for the local energies;
- the loss: a forward and a backward over the set;
- log psi of the HF row;
- MinSR in the per-row form: for each of the k most probable rows one
  forward and one backward, the four k x P x k products of O O^H, four
  matrix-vector products and the 2k x 2k solve.

Elementwise work is left out.

Kernel #1's least time is the larger of its bytes over the card's bandwidth
and its operations over its float32 rate. Its bytes are its own inputs read
once -- each row's 32-bit words, each term's sign-mask words and float32
weight, the (M + 1) int32 group offsets -- and its (B, M) float32 output
written once; its operations one multiply-add (2 flops) a (row, term)
pair. No table that an implementation builds for itself is counted.
"""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name``); raises ``KeyError`` for a card the
    table lacks."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    for name, entry in table.items():
        if name in kind:
            return entry
    raise KeyError(f"no peaks for {kind!r}")


def frontier_rows(widths, sample_num: int):
    """Rows entering each qudit of an autoregressive draw over qudits of
    ``widths`` bits, capped at ``sample_num``."""
    rows, out = 1, []
    for w in widths:
        out.append(rows)
        rows = min(rows << w, sample_num)
    return out


def step_flops(net: dict, rows: int, sr_k: int) -> int:
    """Flops of one training step (module doc). ``net``: the ansatz file's
    ``flops``; ``rows``: the set's rows."""
    f, b, p = net["forward"], net["backward"], net["params"]
    k = min(sr_k, rows)
    n = 2 * k
    minsr = (k * (f + b) + 4 * 2 * k * k * p + 4 * 2 * k * p
             + 2 * n ** 3 // 3 + 2 * n * n)
    return net["sampler"] + rows * f + rows * (f + b) + f + minsr


def me_least_seconds(rows: int, n_words: int, n_terms: int, n_groups: int,
                     peak: dict):
    """(least seconds of kernel #1 on ``rows`` rows, 'bytes' or 'flops':
    which bounds it)."""
    n_bytes = (4 * rows * n_words + n_terms * (4 * n_words + 4)
               + 4 * (n_groups + 1) + 4 * rows * n_groups)
    t_bytes = n_bytes / peak["hbm_bytes_per_s"]
    t_flops = 2 * rows * n_terms / peak["float32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
