"""Write the parameters of a JAX-package checkpoint as a flat npz.

    python tools/export_jax_params.py [CKPT_DIR] [OUT.npz]
    python tools/export_jax_params.py --init OUT.npz

Defaults: ``runs/li2o_closure/ckpt_16000`` (the NADE-(128, 128) state of
the JAX package's Li2O closure leg, ``examples/li2o_closure.py``) ->
``anqs_quantum_chemistry_torch/data/li2o_nade_closure.npz``. The checkpoint
is an orbax tree ``{params, opt_state, key, iter}``; only ``params`` is
written, one float32 array per leaf under its dotted path
(``main.qudit0.w0``, ...), which ``convert.params_from_jax`` reads as the
port's state dict. The support-CI chain's states ship the same way:
``python tools/export_jax_params.py runs/li2o_sci/ckpt_N
anqs_quantum_chemistry_torch/data/li2o_sci_ckptN.npz`` for N = 4, 13, 26.
Needs ``orbax`` (and so JAX) on the machine that runs it; the port itself reads the npz with numpy only. ``--init`` writes
instead the JAX package's initial weights of the Li2O NADE campaign
(``VMC.init_state`` at seed 0: NADE (128, 128), qubit_per_qudit 6), the
start of its CISD pretraining (``tools/li2o_nade_diagnostics.py cisd
--init``).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DEFAULT_SRC = os.path.join(ROOT, "runs", "li2o_closure", "ckpt_16000")
DEFAULT_DST = os.path.join(ROOT, "anqs_quantum_chemistry_torch", "data",
                           "li2o_nade_closure.npz")


def restore_params(path):
    """The ``params`` tree of an orbax checkpoint, as numpy arrays."""
    import jax
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    tree = ckptr.metadata(os.path.abspath(path)).item_metadata.tree
    args = jax.tree.map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray),
                        tree)
    return ckptr.restore(os.path.abspath(path), restore_args=args)["params"]


def li2o_nade_init_params():
    """The JAX package's initial Li2O NADE weights (seed 0)."""
    from anqs_quantum_chemistry_tpu.chem.molecule import Molecule, MolConfig
    from anqs_quantum_chemistry_tpu.experiments.vmc import VMC, VMCConfig
    from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig

    mol = Molecule.create(MolConfig(name="Li2O"),
                          mols_dir=os.path.join(ROOT, "mols"), run_fci=False,
                          run_cisd=False)
    vmc = VMC(mol, VMCConfig(qubit_per_qudit=6, sample_num=8192, seed=0),
              AnqsConfig(net_type="nade", hidden_widths=(128, 128),
                         aux_hidden_widths=(128, 128)))
    return vmc.init_state()[0]


def flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, f"{name}."))
        else:
            out[name] = np.asarray(value, np.float32)
    return out


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) > 2 and argv[1] == "--init":
        flat, dst = flatten(li2o_nade_init_params()), argv[2]
    else:
        src = argv[1] if len(argv) > 1 else DEFAULT_SRC
        dst = argv[2] if len(argv) > 2 else DEFAULT_DST
        flat = flatten(restore_params(src))
    np.savez(dst, **flat)
    print(f"{dst}: {len(flat)} arrays, "
          f"{sum(v.size for v in flat.values())} float32 values")


if __name__ == "__main__":
    main()
