"""Matrix elements and sector local energies of the PyTorch port against the
JAX package.

The port's plain version (``matrix_elements_plain``, the path its wrapper
takes for CPU tensors) is held against the JAX ``'split'`` path and the
Pallas kernel in interpret mode, as ``tests/test_pallas_kernels.py`` runs
it, at atol 1e-6 Ha. The CUDA kernel itself runs only on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from anqs_quantum_chemistry_tpu.experiments.vmc import VMC as JaxVMC
from anqs_quantum_chemistry_tpu.experiments.vmc import VMCConfig as JaxVMCConfig
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.observables.pauli import (
    PauliEngine as JaxPauliEngine,
)
from anqs_quantum_chemistry_tpu.ops import bits as jbits
from anqs_quantum_chemistry_tpu.ops.pallas_kernels import (
    fused_matrix_elements as pallas_fused_matrix_elements,
)
from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops.matrix_elements import (
    fused_matrix_elements,
    plain_operands,
)
from torch_port_common import molecules


def _sources(rng, mol, kind):
    """(B, 1) int64 words: random bit strings, or the N2 main-path batch
    (the 14400 sector determinants + 64 all-ones sentinel rows)."""
    if kind == "random":
        return rng.integers(0, 2**mol.qubit_num, (96, 1)).astype(np.int64)
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    pad = np.full(64, 0xFFFFFFFF, np.uint64)
    return np.concatenate([dets, pad]).astype(np.int64)[:, None]


@pytest.mark.parametrize("name", ["H2O", "N2"])
def test_engine_tables_match_jax(name):
    jmol, mol = molecules(name)
    jeng, eng = JaxPauliEngine(jmol.qubit_ham), PauliEngine(mol.qubit_ham,
                                                            device="cpu")
    b_bits, group_splits = plain_operands(eng.me_tables)
    np.testing.assert_array_equal(
        b_bits.numpy(), np.asarray(jeng.b_bits, np.float32)
    )
    for mine, theirs in zip(group_splits, jeng.group_weight_splits):
        np.testing.assert_array_equal(
            mine.to(torch.float32).numpy(), np.asarray(theirs, np.float32)
        )
    np.testing.assert_array_equal(
        eng.a_words.numpy(), np.asarray(jeng.a_words).astype(np.int64)
    )


@pytest.mark.parametrize("name,kind", [("H2O", "random"), ("N2", "sector")])
def test_plain_matches_jax_split_and_pallas(rng, name, kind):
    jmol, mol = molecules(name)
    jeng, eng = JaxPauliEngine(jmol.qubit_ham), PauliEngine(mol.qubit_ham,
                                                            device="cpu")
    words = _sources(rng, mol, kind)
    jwords = jnp.asarray(words, jnp.uint32)
    me_split = np.asarray(jeng.matrix_elements(jwords))
    x_bits = jbits.unpack(jwords, mol.qubit_num, dtype=jnp.float32)
    tiles = dict(b_tile=32, t_tile=256) if kind == "random" else {}
    with pltpu.force_tpu_interpret_mode():
        me_pallas = np.asarray(pallas_fused_matrix_elements(
            x_bits.astype(jnp.bfloat16), jeng.b_bits.astype(jnp.bfloat16),
            jeng.group_weight_splits, **tiles,
        ))

    launches = fused_matrix_elements.launches
    me = eng.matrix_elements(torch.from_numpy(words))
    assert fused_matrix_elements.launches == launches  # CPU: plain version
    assert me.shape == (len(words), mol.qubit_ham.n_groups)
    np.testing.assert_allclose(me.numpy(), me_split, rtol=0, atol=1e-6)
    np.testing.assert_allclose(me.numpy(), me_pallas, rtol=0, atol=1e-6)


def test_wrapper_refuses_other_devices():
    _, mol = molecules("H2")
    eng = PauliEngine(mol.qubit_ham, device="cpu")
    with pytest.raises(ValueError):
        fused_matrix_elements(torch.zeros((4, 1), dtype=torch.int64,
                                          device="meta"), eng.me_tables)


def _sector_inputs(rng, vmc, n_real):
    """A shuffled sector batch with ~10% invalid rows (all-ones sentinel
    words) and amplitudes of a roughly uniform normalized state."""
    sw = vmc.sector_words.numpy()
    perm = rng.permutation(sw.shape[0])
    valid = (perm < n_real) & (rng.random(len(perm)) < 0.9)
    words = np.where(valid[:, None], sw[perm], 0xFFFFFFFF)
    la = (-0.5 * np.log(n_real) + 0.3 * rng.standard_normal(len(perm)))
    ph = rng.uniform(-3, 3, len(perm))
    return words, la.astype(np.float32), ph.astype(np.float32), valid


@pytest.mark.parametrize("name,use_pos", [("LiH", True), ("LiH", False),
                                          ("N2", True)])
def test_local_energy_sector_matches_jax(rng, name, use_pos):
    jmol, mol = molecules(name)
    kw = dict(sample_num=64, qubit_per_qudit=4)
    jv = JaxVMC(
        jmol,
        JaxVMCConfig(**kw, engine_overrides={"table_pairs_per_row": 1}),
        JaxAnqsConfig(hidden_widths=(8,)),
    )
    v = VMC(mol, VMCConfig(**kw), AnqsConfig(hidden_widths=(8,)),
            device="cpu")
    words, la, ph, valid = _sector_inputs(rng, v, mol.fci_ndet)
    je = jv.engine.local_energy_sector(
        jnp.asarray(words, jnp.uint32), jnp.asarray(la), jnp.asarray(ph),
        jnp.asarray(valid), jv.sector_words, jv.sector_partner_idx,
        jv.sector_partner_found,
        sector_pos=jv.sector_pos if use_pos else None,
    )
    e = v.engine.local_energy_sector(
        torch.from_numpy(words), torch.from_numpy(la), torch.from_numpy(ph),
        torch.from_numpy(valid), v.sector_words, v.sector_partner_idx,
        v.sector_partner_found,
        sector_pos=v.sector_pos if use_pos else None,
    )
    assert int(e.found_pairs) == int(je.found_pairs)
    # atol 1e-5 Ha; at N2's |E_loc| ~ 108 Ha one float32 ulp is 1.5e-5 Ha,
    # so the bound there also admits 4e-7 relative (3 ulps).
    rtol = 4e-7 if name == "N2" else 0.0
    for field in ("e_re", "e_im"):
        np.testing.assert_allclose(
            getattr(e, field).numpy(), np.asarray(getattr(je, field)),
            rtol=rtol, atol=1e-5, err_msg=field,
        )
    for field in ("t_re", "t_im"):
        np.testing.assert_allclose(
            getattr(e, field).numpy(), np.asarray(getattr(je, field)),
            rtol=0, atol=1e-6, err_msg=field,
        )
