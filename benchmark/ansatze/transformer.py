"""The causal transformer ansatz (``net_type`` 'transformer') as the
benchmark counts and checks it: the configurations it covers, its
parameters' names and shapes, its flops, and its plain reference network
(``reference/transformer.py``). The five functions of ``ansatze/made.py``.
"""

import math

from benchlib.work import frontier_rows
from reference.transformer import TransformerAnqs

KEYS = {"net_type", "head_mode", "d_model", "n_layers", "n_heads", "d_ff",
        "logit_cap"}


def check(config: dict) -> None:
    """Raises ``ValueError`` unless the configuration's ``ansatz`` group is
    what this file models: two decoders (main and aux) of ``n_layers``
    pre-LN blocks each, the ``log_abs_phase`` head, an optional logit
    cap."""
    ansatz = config["ansatz"]
    if set(ansatz) != KEYS:
        raise ValueError(f"ansatz keys {sorted(set(ansatz) ^ KEYS)} are not "
                         "the ones ansatze/transformer.py covers")
    if ansatz["head_mode"] != "log_abs_phase":
        raise ValueError(f"head_mode {ansatz['head_mode']!r}: "
                         "ansatze/transformer.py covers 'log_abs_phase' only")
    if int(ansatz["d_model"]) % int(ansatz["n_heads"]):
        raise ValueError(f"d_model {ansatz['d_model']} is not a multiple of "
                         f"n_heads {ansatz['n_heads']}")


def shape(config: dict, sizes: dict) -> dict:
    """Qubits, qudits Q (the tokens), continuations D and the decoders'
    sizes. ``sizes``: ``inputs.molecule_sizes``."""
    n = sizes["qubit_num"]
    qpq = int(config["vmc"]["qubit_per_qudit"])
    widths = [min(qpq, n - s) for s in range(0, n, qpq)]
    a = config["ansatz"]
    return {"n": n, "q": len(widths), "d": 1 << max(widths),
            "d_model": int(a["d_model"]), "n_layers": int(a["n_layers"]),
            "n_heads": int(a["n_heads"]), "d_ff": int(a["d_ff"]),
            "widths": widths}


def param_shapes(s: dict) -> dict:
    """{name: shape} of the parameters, in the program's order: each
    decoder's own tensors, then its blocks'."""
    q, d, dm, ff = s["q"], s["d"], s["d_model"], s["d_ff"]
    block = {"wq": (dm, dm), "wk": (dm, dm), "wv": (dm, dm), "wo": (dm, dm),
             "ln1_scale": (dm,), "ln1_bias": (dm,), "ln2_scale": (dm,),
             "ln2_bias": (dm,), "ff1": (dm, ff), "ff1_b": (ff,),
             "ff2": (ff, dm), "ff2_b": (dm,)}
    out = {}
    for net in ("main", "aux"):
        out.update({f"{net}.embed": (q, d, dm), f"{net}.pos": (q, dm),
                    f"{net}.start": (dm,), f"{net}.head": (dm, d),
                    f"{net}.head_b": (d,)})
        for layer in range(s["n_layers"]):
            out.update({f"{net}.layer{layer}.{k}": shp
                        for k, shp in block.items()})
    return out


def _position(s: dict, keys: int) -> int:
    """Flops of one decoder at one position that attends to ``keys``
    positions: the four projections and the feed-forward of every block,
    the scores and the weighted sum over the keys, and the head."""
    dm = s["d_model"]
    block = 2 * (4 * dm * dm + 2 * dm * s["d_ff"]) + 2 * 2 * dm * keys
    return s["n_layers"] * block + 2 * dm * s["d"]


def flops(s: dict, sample_num: int, sampled: bool) -> dict:
    """Matmul-class flops: ``forward`` both decoders over the Q positions
    of one row (position q attends to the q + 1 up to it); ``backward``
    twice the forward; ``sampler`` a draw with a key/value cache, whatever
    implements it: at each qudit q, the main decoder at position q alone
    for every frontier row (``work.frontier_rows``), attending to q + 1
    positions (none where the step draws no set); ``params`` the parameter
    count."""
    forward = 2 * sum(_position(s, q + 1) for q in range(s["q"]))
    sampler = (sum(rows * _position(s, q + 1) for q, rows in
                   enumerate(frontier_rows(s["widths"], sample_num)))
               if sampled else 0)
    params = sum(math.prod(shp) for shp in param_shapes(s).values())
    return {"forward": forward, "backward": 2 * forward, "sampler": sampler,
            "params": params}


def reference(config: dict, sizes: dict, device):
    """The plain network: ``log_psi(params, bits)`` and its qubit count
    ``n``."""
    a = config["ansatz"]
    return TransformerAnqs(sizes["qubit_num"], sizes["n_alpha"],
                           sizes["n_beta"], config["vmc"]["qubit_per_qudit"],
                           a.get("logit_cap"), a["n_heads"], a["n_layers"],
                           device)
