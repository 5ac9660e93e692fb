"""Shared set-up of the PyTorch-port parity tests (``test_torch_*.py``).

Each parity test runs one input, made from a numpy seed, through a JAX
function and its counterpart in ``anqs_quantum_chemistry_torch``; arrays
cross between the two frameworks as numpy. JAX stays on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from anqs_quantum_chemistry_tpu.chem.molecule import MolConfig
from anqs_quantum_chemistry_tpu.chem.molecule import Molecule as JaxMolecule
from anqs_quantum_chemistry_tpu.experiments.preparation import (
    create_masker as jax_create_masker,
)
from anqs_quantum_chemistry_tpu.models.anqs import ANQS as JaxANQS
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.symmetries import QubitGrouping as JaxGrouping
from anqs_quantum_chemistry_torch.chem.molecule import Molecule
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments.preparation import create_masker
from anqs_quantum_chemistry_torch.models.anqs import ANQS, AnqsConfig
from anqs_quantum_chemistry_torch.symmetries import QubitGrouping

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOLS = os.path.join(ROOT, "mols")


# Molecules whose configuration is not the default one (STO-3G).
MOL_CONFIGS = {"C2H4": dict(basis="6-31g")}


def mol_config(name):
    return MolConfig(name=name, **MOL_CONFIGS.get(name, {}))


def mol_path(name):
    """The ``mols/`` file of ``name`` at its configuration."""
    cfg = mol_config(name)
    return os.path.join(MOLS, name, cfg.to_sha256_str()[:16] + ".npz")


def molecules(name):
    """(JAX Molecule, port Molecule) read from the same ``mols/`` file."""
    jmol = JaxMolecule.create(mol_config(name), mols_dir=MOLS,
                              run_fci=False, run_cisd=False)
    return jmol, Molecule.from_npz(mol_path(name), name=name)


def jax_uniforms(sample_key, shapes):
    """The uniforms the JAX Gumbel sampler draws from ``sample_key``: one
    ``jax.random.uniform`` per qudit step, keys ``split(sample_key, Q)``."""
    subkeys = jax.random.split(sample_key, len(shapes))
    return [
        torch.from_numpy(np.array(jax.random.uniform(
            subkeys[q], shape, dtype=jnp.float32, minval=1e-38, maxval=1.0
        )))
        for q, shape in enumerate(shapes)
    ]


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def build_pair(name, qpq, width=None, seed=1, **anqs_kw):
    """(port Molecule, JAX ANQS, its params, port ANQS with those params)
    for the e_num_spin masker at ``qubit_per_qudit=qpq``: MADE nets of
    ``width``, or the ``AnqsConfig`` fields ``anqs_kw`` in both packages."""
    jmol, mol = molecules(name)
    if width is not None:
        anqs_kw = dict(hidden_widths=(width,), aux_hidden_widths=(width,),
                       **anqs_kw)
    jax_anqs = JaxANQS(
        JaxGrouping.create(jax_create_masker(jmol, "e_num_spin"), qpq),
        JaxAnqsConfig(**anqs_kw),
    )
    params = jax_anqs.init(jax.random.PRNGKey(seed))
    anqs = ANQS(
        QubitGrouping.create(create_masker(mol, "e_num_spin"), qpq),
        AnqsConfig(**anqs_kw),
    )
    anqs.load_state_dict(params_from_jax(to_np(params)))
    return mol, jax_anqs, params, anqs
