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
    random_sector_dets,
    sector_determinants,
    sector_matrix_elements,
)
from anqs_quantum_chemistry_torch.chem.jw import PauliHamiltonian
from anqs_quantum_chemistry_torch.chem.molecule import load_c2h4, load_n2
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops.hash_lookup import (
    hash_lookup,
    hash_lookup_plain,
)
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
    rounding contract and exact float64 sums, so equal bit for bit; and
    within one float32 ulp of the float64 host reference."""
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
    assert torch.equal(me, plain)
    ref = sector_matrix_elements(mol.qubit_ham, words[:512])
    got = me[:512].double().cpu().numpy()
    assert np.all(np.abs(got - ref) <= 1e-6 + 2.4e-7 * np.abs(ref))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card_c2h4(cuda):
    """Two words a determinant and 104278 terms (20776 groups, the largest
    of 1378 terms): bit for bit against the plain version on 1000 random
    determinants of C2H4's (8, 8) sector."""
    mol = load_c2h4()
    dets = random_sector_dets(mol.n_orbitals, mol.n_alpha, mol.n_beta, 1000,
                              np.random.default_rng(5))
    words = np.stack([dets & np.uint64(0xFFFFFFFF), dets >> np.uint64(32)],
                     axis=1).astype(np.int64)
    tables = build_tables(mol.qubit_ham, cuda)
    x = torch.from_numpy(words).to(cuda)
    me = fused_matrix_elements(x, tables)
    plain = matrix_elements_plain(x, tables)
    torch.cuda.synchronize()
    assert torch.equal(me, plain)
    ref = sector_matrix_elements(mol.qubit_ham, dets[:64])
    got = me[:64].double().cpu().numpy()
    assert np.all(np.abs(got - ref) <= 1e-6 + 2.4e-7 * np.abs(ref))


def _synthetic_ham(qubits, rng):
    """A grouped Hamiltonian of ~24k terms: one 1000-term group among
    groups of 1-8 terms, random sign masks, weights of 1e-4..1 Ha."""
    sizes = rng.integers(1, 9, 5000)
    sizes[1234] = 1000
    n_terms = int(sizes.sum())
    n_words = -(-qubits // 32)
    b = rng.integers(0, 1 << 32, (n_terms, n_words), dtype=np.int64)
    if qubits % 32:
        b[:, -1] &= (1 << (qubits % 32)) - 1
    weights = (rng.choice([-1.0, 1.0], n_terms)
               * 10.0 ** rng.uniform(-4, 0, n_terms))
    return PauliHamiltonian(
        qubit_num=qubits, constant=0.0,
        a_masks=np.zeros((len(sizes), n_words), np.uint32),
        b_words=b.astype(np.uint32), weights=weights,
        group_starts=np.concatenate([[0], np.cumsum(sizes)]),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("qubits", [40, 100])
def test_kernel_matches_plain_on_card_large_t(cuda, qubits):
    """Above 20k terms (the old kernel's shared-memory limit), with a
    1000-term group, at two and four words a determinant: bit for bit."""
    rng = np.random.default_rng(qubits)
    ham = _synthetic_ham(qubits, rng)
    assert ham.n_terms > 20_000
    tables = build_tables(ham, cuda)
    words = rng.integers(0, 1 << 32, (777, ham.b_words.shape[1]),
                         dtype=np.int64)
    x = torch.from_numpy(words).to(cuda)
    me = fused_matrix_elements(x, tables)
    plain = matrix_elements_plain(x, tables)
    torch.cuda.synchronize()
    assert torch.equal(me, plain)


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


def _hash_case(device, w, n=4096, n_queries=1 << 18, seed=3):
    """A bucket table of ``n`` random ``w``-word keys (a few invalid, one
    whose bits read as a float NaN) and queries: hits, misses that share
    key_lo with an entry, and random misses."""
    rng = np.random.default_rng(seed + w)
    keys = rng.integers(0, 1 << 32, (n, w), dtype=np.int64)
    keys[0, 0] = 0x7FC00001
    valid = np.ones(n, bool)
    valid[-16:] = False
    la = rng.standard_normal(n).astype(np.float32)
    ph = rng.uniform(-3, 3, n).astype(np.float32)
    engine = PauliEngine(load_n2().qubit_ham, device=device,
                         membership="hash")
    tab, _, overflow = engine._hash_build(
        *(torch.from_numpy(a).to(device) for a in (keys, la, ph, valid))
    )
    assert int(overflow) == 0
    q = keys[rng.integers(0, n, n_queries)]
    kind = rng.integers(0, 3, n_queries)
    q[kind == 1, w - 1] ^= 1 << 7  # key_lo of an entry when w == 2
    q[kind == 2] = rng.integers(0, 1 << 32, (int((kind == 2).sum()), w))
    # Queries: the keys' 32-bit words as int32 bits, no high words at w = 1.
    q = torch.from_numpy(q.astype(np.uint32).view(np.int32)).to(device)
    q_hi = q[:, 1].contiguous() if w == 2 else None
    return tab, q[:, 0].contiguous(), q_hi


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2])
def test_hash_lookup_matches_plain_on_card(cuda, w):
    """The kernel against its plain version, bit for bit (a gather and a
    select: no arithmetic on the values)."""
    tab, q_lo, q_hi = _hash_case(cuda, w)
    launches = hash_lookup.launches
    got = hash_lookup(tab, q_lo, q_hi)
    assert hash_lookup.launches == launches + 1
    want = hash_lookup_plain(tab, q_lo, q_hi)
    torch.cuda.synchronize()
    for g, p in zip(got[:2], want[:2]):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))
    assert torch.equal(got[2], want[2])
    assert 0 < int(got[2].sum()) < q_lo.numel()


@pytest.mark.cuda
def test_hash_lookup_rejects_bad_inputs(cuda):
    tab, q_lo, q_hi = _hash_case(cuda, 2, n_queries=64)
    with pytest.raises(ValueError):  # int64 queries
        hash_lookup(tab, q_lo.to(torch.int64), q_hi.to(torch.int64))
    with pytest.raises(ValueError):  # an int64 high word
        hash_lookup(tab, q_lo, q_hi.to(torch.int64))
    with pytest.raises(ValueError):  # queries on the CPU
        hash_lookup(tab, q_lo.cpu(), q_hi.cpu())
    with pytest.raises(ValueError):  # non-contiguous queries
        hash_lookup(tab, q_lo[::2], q_hi[::2])
    with pytest.raises(ValueError):  # float64 table
        hash_lookup(tab.double(), q_lo, q_hi)
