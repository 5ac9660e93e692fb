"""Cr2/SV at 84 qubits: the packaged molecule, the trainer's configuration
and the packaged JAX state, against the JAX package's records.

- ``data/cr2_sv.npz`` (built from atoms by the port, ``chem/molecule.py``):
  the sizes and sector of ``runs/cr2_prep_summary.json`` exactly; HF (the
  HF determinant's energy by the Slater-Condon rules) and MP2 recomputed
  from the packed integrals, each within 1e-8 Ha of the record; the Pauli
  form's elements at the HF determinant and a single and a double
  excitation of it equal to the integrals' to 1e-9 Ha.
- The configuration of ``experiments/cr2_step.py`` and ``cr2_train.py``
  (``experiments.vmc.cr2_config``, ``CR2_ANQS``) field by field against
  ``runs/cr2_train/config.json`` and the examples' ``AnqsConfig``.
- ``data/cr2_train_ckpt1000.npz``: the orbax state ``runs/cr2_train/
  ckpt_1000`` leaf by leaf, and log|psi| and the phase of 64 sector
  determinants against the JAX ansatz on the CPU to 1e-5.
"""

import dataclasses
import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.experiments.preparation import (
    create_masker as jax_create_masker,
)
from anqs_quantum_chemistry_tpu.models.anqs import ANQS as JaxANQS
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.ops import bits as jbits
from anqs_quantum_chemistry_tpu.symmetries import QubitGrouping as JaxGrouping
from anqs_quantum_chemistry_torch.chem.fci import (
    diagonal_energy,
    matrix_element,
    mp2_energy,
)
from anqs_quantum_chemistry_torch.chem.molecule import (
    CR2_SV,
    INTEGRAL_KEYS,
    PACKAGED_KEYS,
    PACKED_KEYS,
    SPATIAL_KEYS,
    load_cr2,
)
from anqs_quantum_chemistry_torch.experiments import vmc as vmc_mod
from anqs_quantum_chemistry_torch.experiments.preparation import create_masker
from anqs_quantum_chemistry_torch.models.anqs import ANQS
from anqs_quantum_chemistry_torch.ops import bits
from anqs_quantum_chemistry_torch.symmetries import QubitGrouping

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(ROOT, "runs")
# The packaged file's size limit: the repository carries it.
MAX_BYTES = 45e6


@pytest.fixture(scope="module")
def cr2():
    return load_cr2()


@pytest.fixture(scope="module")
def record():
    with open(os.path.join(RUNS, "cr2_prep_summary.json")) as f:
        return json.load(f)


def test_packaged_file(cr2, record):
    assert os.path.getsize(CR2_SV) < MAX_BYTES
    with np.load(CR2_SV) as data:
        assert set(PACKAGED_KEYS + PACKED_KEYS) <= set(data.files)
        assert set(INTEGRAL_KEYS + SPATIAL_KEYS[1:]).isdisjoint(data.files)
        assert data["eri_packed"].shape == (903 * 904 // 2,)
    ham = cr2.qubit_ham
    assert (cr2.qubit_num, cr2.n_electrons, [cr2.n_alpha, cr2.n_beta],
            ham.n_terms, ham.n_groups) == (
        record["qubits"], record["n_electrons"], record["sector"],
        record["n_terms"], record["n_groups"])
    assert ham.a_masks.shape == (ham.n_groups, 3)
    assert cr2.fci_energy is None and cr2.h1.shape == (84, 84)
    assert abs(cr2.hf_energy - record["hf_energy"]) <= 1e-8
    assert abs(cr2.mp2_energy - record["mp2_energy"]) <= 1e-8


def test_hf_and_mp2_from_packed_integrals(cr2, record):
    """The energies recomputed from the integrals that the file packs."""
    hf = diagonal_energy(cr2.hf_det, cr2.h1, cr2.v) + cr2.e_nuc
    mp2 = hf + mp2_energy(cr2.h1, cr2.v, np.repeat(cr2.mo_energy, 2),
                          cr2.hf_det)
    assert abs(hf - record["hf_energy"]) <= 1e-8
    assert abs(mp2 - record["mp2_energy"]) <= 1e-8


def _pauli_element(ham, x: int, y: int) -> float:
    """<y|H|x> of the Pauli form: the group of flip x ^ y, its terms'
    signs on x (numpy over that group only)."""
    w = ham.a_masks.shape[1]
    flip = np.array([((x ^ y) >> (32 * j)) & 0xFFFFFFFF for j in range(w)],
                    np.uint32)
    m = np.flatnonzero(np.all(ham.a_masks == flip, axis=1))
    if not len(m):
        return 0.0
    lo, hi = ham.group_starts[m[0]], ham.group_starts[m[0] + 1]
    xw = np.array([(x >> (32 * j)) & 0xFFFFFFFF for j in range(w)],
                  np.uint64)
    par = np.bitwise_count(ham.b_words[lo:hi].astype(np.uint64) & xw).sum(1)
    val = float(np.sum(ham.weights[lo:hi] * (1.0 - 2.0 * (par % 2))))
    return val + (ham.constant if x == y else 0.0)


def test_pauli_form_matches_integrals(cr2):
    """The Jordan-Wigner form holds the integrals' Hamiltonian: at the HF
    determinant (with the constant) and at a single and a double
    excitation of it (within one spin)."""
    hf = cr2.hf_det
    single = hf ^ (1 << 46) ^ (1 << 48)  # alpha 23 -> 24
    double = hf ^ (1 << 44) ^ (1 << 46) ^ (1 << 50) ^ (1 << 52)
    for y in (hf, single, double):
        want = matrix_element(y, hf, cr2.h1, cr2.v) + (
            cr2.e_nuc if y == hf else 0.0)
        assert abs(_pauli_element(cr2.qubit_ham, hf, y) - want) <= 1e-9


def test_trainer_config_matches_jax():
    """``cr2_config`` (what both entry points build) against the JAX run's
    ``config.json``, every field of JAX's (the sector-membership switch
    and its thresholds among them) and no other; and the ansatz against the
    examples' ``AnqsConfig(hidden_widths=(1024,), logit_cap=8.0)``, field
    for field."""
    with open(os.path.join(RUNS, "cr2_train", "config.json")) as f:
        want = json.load(f)
    got = vmc_mod.cr2_config(iter_num=1000).to_dict()
    assert got["engine_overrides"] == want["engine_overrides"] == (
        vmc_mod.CR2_ENGINE)
    for key in sorted(set(got) & set(want) - {"sr"}):
        assert got[key] == want[key], key
    assert got["sr"] == want["sr"]
    assert set(got) == set(want)
    jax_cfg = dataclasses.asdict(JaxAnqsConfig(hidden_widths=(1024,),
                                               logit_cap=8.0))
    port_cfg = dataclasses.asdict(vmc_mod.CR2_ANQS)
    assert set(port_cfg) == set(jax_cfg)
    for key in set(port_cfg) & set(jax_cfg):
        assert port_cfg[key] == jax_cfg[key], key


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_jax_params", os.path.join(ROOT, "tools",
                                          "export_jax_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_packaged_state_matches_jax():
    """The exported ckpt_1000 equals the orbax state; loaded into the
    port's Cr2 ansatz it gives the JAX ansatz's log|psi| and phase on 64
    random (24, 24) determinants of the 84-qubit register to 1e-5."""
    tool = _export_tool()
    params = tool.restore_params(os.path.join(RUNS, "cr2_train",
                                              "ckpt_1000"))
    flat = tool.flatten(params)
    path = os.path.join(os.path.dirname(CR2_SV), vmc_mod.CR2_CKPT1000)
    with np.load(path) as d:
        assert sorted(d.files) == sorted(flat)
        for key, value in flat.items():
            np.testing.assert_array_equal(d[key], value, err_msg=key)
    mol = types.SimpleNamespace(qubit_num=84, n_electrons=48, n_alpha=24,
                                n_beta=24)
    jax_anqs = JaxANQS(
        JaxGrouping.create(jax_create_masker(mol, "e_num_spin"), 6),
        JaxAnqsConfig(hidden_widths=(1024,), logit_cap=8.0))
    anqs = ANQS(QubitGrouping.create(create_masker(mol, "e_num_spin"), 6),
                vmc_mod.CR2_ANQS)
    state = vmc_mod.cr2_ckpt1000_params()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in anqs.state_dict().items()}
    anqs.load_state_dict(state)
    rng = np.random.default_rng(1000)
    bit_rows = np.zeros((64, 84), np.int64)
    for spin in (0, 1):
        occ = np.argsort(rng.random((64, 42)), axis=1)[:, :24]
        np.put_along_axis(bit_rows, 2 * occ + spin, 1, axis=1)
    bit_rows[0] = [1] * 48 + [0] * 36  # the HF determinant
    jw = jbits.pack(jnp.asarray(bit_rows))
    la_j, ph_j = jax.jit(jax_anqs.log_psi)(params, jw)
    with torch.no_grad():
        la, ph = anqs.log_psi(bits.pack(torch.from_numpy(bit_rows)))
    np.testing.assert_array_equal(np.asarray(jw).astype(np.int64),
                                  bits.pack(torch.from_numpy(bit_rows)))
    assert bool(torch.all(torch.isfinite(la)))
    np.testing.assert_allclose(la.numpy(), np.asarray(la_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_j), rtol=0,
                               atol=1e-5)
