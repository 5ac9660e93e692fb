"""Tests of the PyTorch port that need the card (marker ``cuda``).

They skip without a CUDA device, so here they count no pass; on the machine
with the card run them with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. This file imports no JAX (that machine has
none): the port's own N2 file and plain versions are the references.
"""

import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_torch.chem.fci import (
    sector_determinants,
    sector_matrix_elements,
)
from anqs_quantum_chemistry_torch.chem.molecule import load_n2
from anqs_quantum_chemistry_torch.ops.matrix_elements import (
    build_tables,
    fused_matrix_elements,
    matrix_elements_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the machine with the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 14464])
def test_kernel_matches_plain_on_card(cuda, rows):
    """The kernel against its plain version on N2 sector determinants plus
    all-ones sentinel rows (the main path's batch at rows=14464): the same
    rounding contract, so equal to 1e-6 Ha; and within one float32 ulp of
    the float64 host reference."""
    mol = load_n2()
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    words = np.concatenate([dets, np.full(64, 0xFFFFFFFF, np.uint64)])
    words = words[np.linspace(0, len(words) - 1, rows).astype(int)]
    tables = build_tables(mol.qubit_ham, cuda)
    x = torch.from_numpy(words.astype(np.int64)[:, None]).to(cuda)
    launches = fused_matrix_elements.launches
    me = fused_matrix_elements(x, tables)
    assert fused_matrix_elements.launches == launches + 1
    plain = matrix_elements_plain(x, tables)
    torch.cuda.synchronize()
    assert float((me - plain).abs().max()) <= 1e-6
    ref = sector_matrix_elements(mol.qubit_ham, words[:512])
    got = me[:512].double().cpu().numpy()
    assert np.all(np.abs(got - ref) <= 1e-6 + 2.4e-7 * np.abs(ref))


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    tables = build_tables(load_n2().qubit_ham, cuda)
    with pytest.raises(ValueError):  # int32 words
        fused_matrix_elements(torch.zeros((4, 1), dtype=torch.int32,
                                          device=cuda), tables)
    with pytest.raises(ValueError):  # two words against one-word tables
        fused_matrix_elements(torch.zeros((4, 2), dtype=torch.int64,
                                          device=cuda), tables)
    with pytest.raises(ValueError):  # tables on the CPU
        fused_matrix_elements(
            torch.zeros((4, 1), dtype=torch.int64, device=cuda),
            build_tables(load_n2().qubit_ham, "cpu"),
        )
