"""The MADE ansatz (``net_type`` 'made') as the benchmark counts and checks
it: the configurations it covers, its parameters' names and shapes, its
flops, and its plain reference network (``reference/ansatz.py``).

Each ansatz the benchmark runs has a file ``ansatze/<net_type>.py`` with
these five functions; a configuration whose ansatz keys its file does not
cover is refused before the run starts.
"""

from benchlib.work import frontier_rows
from reference.ansatz import MadeAnqs

KEYS = {"net_type", "head_mode", "hidden_widths", "aux_hidden_widths",
        "logit_cap"}


def check(config: dict) -> None:
    """Raises ``ValueError`` unless the configuration's ``ansatz`` group is
    what this file models: two networks (main and aux) of one tanh hidden
    layer each, the ``log_abs_phase`` head, an optional logit cap."""
    ansatz = config["ansatz"]
    if set(ansatz) != KEYS:
        raise ValueError(f"ansatz keys {sorted(set(ansatz) ^ KEYS)} are not "
                         "the ones ansatze/made.py covers")
    if ansatz["head_mode"] != "log_abs_phase":
        raise ValueError(f"head_mode {ansatz['head_mode']!r}: "
                         "ansatze/made.py covers 'log_abs_phase' only")
    for key in ("hidden_widths", "aux_hidden_widths"):
        if len(ansatz[key]) != 1:
            raise ValueError(f"{key} {ansatz[key]}: ansatze/made.py covers "
                             "one hidden layer only")


def shape(config: dict, sizes: dict) -> dict:
    """Qubits, qudits Q, continuations D and the widths of both nets.
    ``sizes``: ``inputs.molecule_sizes``."""
    n = sizes["qubit_num"]
    qpq = int(config["vmc"]["qubit_per_qudit"])
    widths = [min(qpq, n - s) for s in range(0, n, qpq)]
    return {"n": n, "q": len(widths), "d": 1 << max(widths),
            "hidden": int(config["ansatz"]["hidden_widths"][0]),
            "aux_hidden": int(config["ansatz"]["aux_hidden_widths"][0]),
            "widths": widths}


def param_shapes(s: dict) -> dict:
    """{name: shape} of the parameters, in the program's order."""
    out = s["q"] * s["d"]
    return {"main.w0": (s["n"], s["hidden"]), "main.b0": (s["hidden"],),
            "main.w1": (s["hidden"], out), "main.b1": (out,),
            "aux.w0": (s["n"], s["aux_hidden"]), "aux.b0": (s["aux_hidden"],),
            "aux.w1": (s["aux_hidden"], out), "aux.b1": (out,)}


def _fwd(dims):
    return sum(2 * a * b for a, b in dims)


def flops(s: dict, sample_num: int, sampled: bool) -> dict:
    """Matmul-class flops: ``forward`` and ``backward`` of both networks on
    one row (a backward counts every layer's weight gradient and every
    layer's input gradient but the first's), ``sampler`` the main
    network's forwards over the frontier entering each qudit in one step
    (none where the step draws no set), ``params`` the parameter count."""
    out = s["q"] * s["d"]
    nets = ([(s["n"], s["hidden"]), (s["hidden"], out)],
            [(s["n"], s["aux_hidden"]), (s["aux_hidden"], out)])
    sampler = (sum(frontier_rows(s["widths"], sample_num)) * _fwd(nets[0])
               if sampled else 0)
    return {"forward": sum(_fwd(d) for d in nets),
            "backward": sum(_fwd(d) + _fwd(d[1:]) for d in nets),
            "sampler": sampler,
            "params": sum(a * b + b for d in nets for a, b in d)}


def reference(config: dict, sizes: dict, device):
    """The plain network: ``log_psi(params, bits)`` and its qubit count
    ``n``."""
    return MadeAnqs(sizes["qubit_num"], sizes["n_alpha"], sizes["n_beta"],
                    config["vmc"]["qubit_per_qudit"],
                    config["ansatz"].get("logit_cap"), device)
