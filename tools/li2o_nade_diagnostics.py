"""Diagnostics of the Li2O NADE campaign's legs on one card.

    python tools/li2o_nade_diagnostics.py distill ITERS TAU [--tf32]
    python tools/li2o_nade_diagnostics.py cisd ITERS [--init FILE] [--tf32]
        [--precision P] [--run NAME]

``distill`` runs ``experiments.li2o_distill_closure`` (from the JAX
package's closure state) for ITERS iterations at ``distill_tau`` TAU and
prints, for every distillation cycle, the support's energy E, the range of
its local energies, and the Born and target mass of the rows below E and
of those above E + 2/TAU, which the propagator 1 - TAU (E_loc - E)
amplifies. ``cisd`` runs ``experiments.cisd_pretrain_vmc li2o ITERS``;
``--init FILE`` starts its pretraining from the weights in FILE (an npz of
dotted JAX names, e.g. the JAX package's initial weights written by
``tools/export_jax_params.py --init``). ``--tf32`` lets float32 matmuls
run as TF32 (the port switches TF32 off). ``--precision P`` sets both
NADE nets' ``matmul_precision`` (e.g. 'bfloat16', the TPU's one-pass
arithmetic, under which the JAX campaign's record was made). Run
directories go under ``build/diagnostics``, in ``NAME`` (``--run``) when
given. Needs a CUDA card; imports no JAX.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from anqs_quantum_chemistry_torch.convert import params_from_jax  # noqa: E402
from anqs_quantum_chemistry_torch.experiments import (  # noqa: E402
    cisd_pretrain_vmc,
    li2o_distill_closure,
)
from anqs_quantum_chemistry_torch.experiments import vmc as vmc_module  # noqa: E402

RUN_ROOT = os.path.join("build", "diagnostics")


def summarised_it_targets(la, ph, e_re, e_im, valid, tau):
    """``vmc.it_targets``, printing where the target moves mass."""
    la_t, ph_t, m_re = it_targets(la, ph, e_re, e_im, valid, tau)
    p = torch.where(valid, torch.exp(2.0 * la.double()), 0.0)
    p = p / p.sum()
    z = torch.where(valid, 2.0 * la_t.double(), -torch.inf)
    pt = torch.exp(z - z.max())
    pt = pt / pt.sum()
    high = valid & (e_re.double() - m_re > 2.0 / tau)
    low = valid & (e_re.double() < m_re)
    print(f"cycle: E {float(m_re):.6f} E_loc [{float(e_re[valid].min()):.2f},"
          f" {float(e_re[valid].max()):.2f}]; rows above E + 2/tau "
          f"{int(high.sum())} (p {float(p[high].sum()):.3e} -> target "
          f"{float(pt[high].sum()):.3e}); rows below E {int(low.sum())} "
          f"(p {float(p[low].sum()):.3e} -> target {float(pt[low].sum()):.3e})",
          flush=True)
    return la_t, ph_t, m_re


it_targets = vmc_module.it_targets


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("li2o_nade_diagnostics: needs a CUDA device")
    if "--tf32" in argv:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    mode, iters = argv[1], argv[2]
    if mode == "distill":
        vmc_module.it_targets = summarised_it_targets
        li2o_distill_closure.main(["li2o_distill_closure", "", iters,
                                   argv[3]], run_root=RUN_ROOT)
    elif mode == "cisd":
        if "--init" in argv:
            with np.load(argv[argv.index("--init") + 1]) as data:
                init = params_from_jax(dict(data))
            init_state = vmc_module.VMC.init_state

            def init_from_file(self):
                state = init_state(self)
                self.anqs.load_state_dict(init)
                return state

            vmc_module.VMC.init_state = init_from_file
        if "--precision" in argv:
            cisd_pretrain_vmc.NETS["nade"] = dataclasses.replace(
                cisd_pretrain_vmc.NETS["nade"],
                matmul_precision=argv[argv.index("--precision") + 1])
        root = (os.path.join(RUN_ROOT, argv[argv.index("--run") + 1])
                if "--run" in argv else RUN_ROOT)
        cisd_pretrain_vmc.main(["cisd_pretrain_vmc", "li2o", iters],
                               run_root=root)
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main(sys.argv)
