"""Write the parameters of JAX-package checkpoints as flat npz files.

    python tools/export_jax_params.py
    python tools/export_jax_params.py CKPT_DIR OUT.npz
    python tools/export_jax_params.py --init OUT.npz
    python tools/export_jax_params.py --anchor

With no arguments it writes every JAX state that ships with the port
(``EXPORTS``) into ``anqs_quantum_chemistry_torch/data/``:

- ``runs/li2o_closure/ckpt_16000`` -> ``li2o_nade_closure.npz``, the
  NADE-(128, 128) state of the Li2O closure leg
  (``examples/li2o_closure.py``);
- ``runs/li2o_sci/ckpt_N`` -> ``li2o_sci_ckptN.npz`` for N = 4, 13, 26, the
  Li2O support-CI chain (``examples/li2o_support_ci.py``,
  ``li2o_sci_polish.py``);
- ``runs/c2h4_cisd_made/ckpt_4000`` -> ``c2h4_cisd_made_ckpt4000.npz``, the
  CISD-pretrained MADE-2048 after 4000 VMC iterations
  (``examples/cisd_pretrain_vmc.py``), the C2H4 closure's warm start;
- ``runs/c2h4_sci/ckpt_47`` -> ``c2h4_sci_ckpt47.npz``, the C2H4 closure's
  best stage (``examples/c2h4_support_ci.py rql``);
- ``runs/c2h4_cisd_transformer_emp_lr0.0001/ckpt_3000`` ->
  ``c2h4_cisd_transformer_ckpt3000.npz``, the CISD-pretrained transformer
  (``examples/c2h4_support_transformer.py``'s warm start);
- ``runs/cr2_train/ckpt_1000`` -> ``cr2_train_ckpt1000.npz``, the end state
  of the Cr2/SV training leg (``examples/cr2_train.py``: MADE 1024 with
  logit_cap 8, qubit_per_qudit 6).

(The C2H4 CISD vector and selected-CI target ship as copies of
``runs/c2h4_cisd_vector.npz`` and ``runs/c2h4_sci/target.npz``:
``data/c2h4_cisd_vector.npz``, ``data/c2h4_sci_target.npz``.)

A checkpoint is an orbax tree ``{params, opt_state, key, iter}``; only
``params`` is written, one float32 array per leaf under its dotted path
(``main.qudit0.w0``, ...), which ``convert.params_from_jax`` reads as the
port's state dict. Needs ``orbax`` (and so JAX) on the machine that runs
it; the port itself reads the npz with numpy only. ``--init`` writes
instead the JAX package's initial weights of the Li2O NADE campaign
(``VMC.init_state`` at seed 0: NADE (128, 128), qubit_per_qudit 6), the
start of its CISD pretraining (``tools/li2o_nade_float32_check.py cisd``).
``--anchor`` writes ``data/c2h4_transformer_logpsi.npz``: log|psi| and the
phase of the packaged transformer state (JAX's ansatz at 'highest', float32
on the CPU) over the top ``ANCHOR_ROWS`` determinants of the C2H4 target
by |coef|, which ``chip_smoke.py`` holds the port to on the card.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "anqs_quantum_chemistry_torch", "data")
# The C2H4 transformer state that ``--anchor`` evaluates.
TRANSFORMER_STATE = "c2h4_cisd_transformer_ckpt3000.npz"
# (checkpoint under runs/, npz under the port's data/).
EXPORTS = (
    ("li2o_closure/ckpt_16000", "li2o_nade_closure.npz"),
    ("li2o_sci/ckpt_4", "li2o_sci_ckpt4.npz"),
    ("li2o_sci/ckpt_13", "li2o_sci_ckpt13.npz"),
    ("li2o_sci/ckpt_26", "li2o_sci_ckpt26.npz"),
    ("c2h4_cisd_made/ckpt_4000", "c2h4_cisd_made_ckpt4000.npz"),
    ("c2h4_sci/ckpt_47", "c2h4_sci_ckpt47.npz"),
    ("c2h4_cisd_transformer_emp_lr0.0001/ckpt_3000", TRANSFORMER_STATE),
    ("cr2_train/ckpt_1000", "cr2_train_ckpt1000.npz"),
)


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


ANCHOR_ROWS = 512
ANCHOR = os.path.join(DATA, "c2h4_transformer_logpsi.npz")


def c2h4_transformer_anchor():
    """{log_abs, phase} of JAX's transformer ansatz (the C2H4 CISD run's)
    with the packaged ckpt_3000 weights, over the target's top
    ``ANCHOR_ROWS`` determinants by |coef| (ascending)."""
    import jax.numpy as jnp

    from anqs_quantum_chemistry_tpu.chem.molecule import Molecule, MolConfig
    from anqs_quantum_chemistry_tpu.chem.selected_ci import (
        truncate_by_weight,
    )
    from anqs_quantum_chemistry_tpu.experiments.preparation import (
        create_masker,
    )
    from anqs_quantum_chemistry_tpu.models.anqs import ANQS, AnqsConfig
    from anqs_quantum_chemistry_tpu.optim.pretrain import pack_dets
    from anqs_quantum_chemistry_tpu.symmetries import QubitGrouping

    mol = Molecule.create(MolConfig(name="C2H4", basis="6-31g"),
                          mols_dir=os.path.join(ROOT, "mols"), run_fci=False)
    anqs = ANQS(QubitGrouping.create(create_masker(mol, "e_num_spin"), 4),
                AnqsConfig(net_type="transformer", d_model=128, n_heads=8,
                           n_layers=3, d_ff=512, logit_cap=4.0,
                           matmul_precision="highest"))
    params = {}
    with np.load(os.path.join(DATA, TRANSFORMER_STATE)) as d:
        for name in d.files:
            node = params
            *path, leaf = name.split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(d[name])
    with np.load(os.path.join(DATA, "c2h4_sci_target.npz")) as t:
        dets, _ = truncate_by_weight([int(x) for x in t["dets"]], t["coef"],
                                     ANCHOR_ROWS)
    la, ph = anqs.log_psi(params, pack_dets(dets, mol.qubit_num))
    return {"log_abs": np.asarray(la, np.float32),
            "phase": np.asarray(ph, np.float32)}


def flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, f"{name}."))
        else:
            out[name] = np.asarray(value, np.float32)
    return out


def export(src, dst, flat=None):
    flat = flatten(restore_params(src)) if flat is None else flat
    np.savez(dst, **flat)
    print(f"{dst}: {len(flat)} arrays, "
          f"{sum(v.size for v in flat.values())} float32 values")


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if argv[1:] == ["--anchor"]:
        np.savez(ANCHOR, **c2h4_transformer_anchor())
        print(f"{ANCHOR}: {ANCHOR_ROWS} rows")
    elif len(argv) > 2 and argv[1] == "--init":
        export(None, argv[2], flatten(li2o_nade_init_params()))
    elif len(argv) > 2:
        export(argv[1], argv[2])
    else:
        for src, dst in EXPORTS:
            export(os.path.join(ROOT, "runs", src), os.path.join(DATA, dst))


if __name__ == "__main__":
    main()
