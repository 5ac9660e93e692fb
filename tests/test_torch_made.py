"""MADE ansatz of the PyTorch port against the JAX package from the same
weights (``convert.params_from_jax``): log|psi| and phase to float32
rounding (atol 1e-5), symmetry bookkeeping exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.models.made import made_masks as jax_masks
from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
from anqs_quantum_chemistry_torch.models.anqs import NEG
from anqs_quantum_chemistry_torch.models.made import made_masks
from torch_port_common import build_pair


@pytest.mark.parametrize("name,qpq,width,rows", [
    ("N2", 10, 512, 1024),
    ("LiH", 6, 32, 225),
    ("LiH", 4, 32, 225),
])
def test_log_psi_matches_jax(rng, name, qpq, width, rows):
    mol, jax_anqs, params, anqs = build_pair(name, qpq, width)
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    words = np.concatenate([
        rng.choice(dets, rows, replace=False),
        rng.integers(0, 2**mol.qubit_num, 32).astype(np.uint64),
    ]).astype(np.int64)[:, None]

    la_j, ph_j = jax_anqs.log_psi(params, jnp.asarray(words, jnp.uint32))
    with torch.no_grad():
        la, ph = anqs.log_psi(torch.from_numpy(words))
    np.testing.assert_allclose(la.numpy(), np.asarray(la_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_j), rtol=0,
                               atol=1e-5)
    # Sector members are normalized amplitudes; non-members are masked.
    assert np.all(la[:rows].numpy() > 0.5 * NEG)
    assert np.all(la[:rows].numpy() <= 1e-6)

    memo_j, mask_j = jax_anqs.memo_path(jnp.asarray(words, jnp.uint32))
    memo, mask = anqs.memo_path(torch.from_numpy(words))
    np.testing.assert_array_equal(memo.numpy(), np.asarray(memo_j))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))


def test_made_masks_match_jax():
    mol, jax_anqs, _, anqs = build_pair("LiH", 4, 16)
    for m, jm in zip(made_masks(anqs.main.spec),
                     jax_masks(jax_anqs.main_spec)):
        np.testing.assert_array_equal(m, jm)


def test_probabilities_normalized_over_sector():
    """sum |psi|^2 over the whole sector is 1 (autoregressive + masks)."""
    mol, _, _, anqs = build_pair("LiH", 6, 32)
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    with torch.no_grad():
        la, _ = anqs.log_psi(torch.from_numpy(dets.astype(np.int64)[:, None]))
    assert abs(float(torch.exp(2 * la.double()).sum()) - 1.0) < 1e-5
