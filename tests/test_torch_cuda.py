"""Tests of the PyTorch port that need the card (marker ``cuda``).

They skip without a CUDA device, so here they count no pass; on the machine
with the card run them with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. This file imports no JAX (that machine has
none): the port's own N2 file and plain versions are the references.
"""

import functools

import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_torch.applications.spin_systems import (
    dm_chain_hamiltonian,
    tfi_hamiltonian,
)
from anqs_quantum_chemistry_torch.chem.fci import (
    random_sector_dets,
    sector_determinants,
    sector_matrix_elements,
)
from anqs_quantum_chemistry_torch.chem.jw import PauliHamiltonian
from anqs_quantum_chemistry_torch.chem.molecule import (
    load_c2h4,
    load_cr2,
    load_n2,
)
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops.hash_lookup import (
    ENTRIES,
    LAYOUTS,
    NEG,
    ROW,
    fp_filter,
    fp_filter_plain,
    fp_in_shared_memory,
    hash_lookup,
    hash_lookup_plain,
    hash_tags,
    hash_tags_plain,
    mix2,
    tag_of,
    tags_in_shared_memory,
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
@pytest.mark.parametrize("chain", ["dm40", "tfi64"])
def test_kernel_matches_plain_on_card_spin_chains(cuda, chain):
    """Tables where two groups share each flip mask (the XY+DM chain at 40
    sites: its real and imaginary channels) and where most groups hold one
    term (the TFI chain at 64 sites): bit for bit against the plain version
    on 8192 random two-word rows."""
    ham = (dm_chain_hamiltonian(40) if chain == "dm40"
           else tfi_hamiltonian(64))
    n = ham.qubit_num
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (8192, n), dtype=np.uint64)
    dets = (bits << np.arange(n, dtype=np.uint64)).sum(axis=1,
                                                       dtype=np.uint64)
    words = np.stack([dets & np.uint64(0xFFFFFFFF), dets >> np.uint64(32)],
                     axis=1).astype(np.int64)
    tables = build_tables(ham, cuda)
    x = torch.from_numpy(words).to(cuda)
    me = fused_matrix_elements(x, tables)
    plain = matrix_elements_plain(x, tables)
    torch.cuda.synchronize()
    assert me.shape == (8192, ham.n_groups)
    assert torch.equal(me, plain)


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


def _hash_case(device, w, n=4096, n_queries=1 << 18, seed=3,
               extra_bits=0):
    """A bucket table of ``n`` random ``w``-word keys (a few invalid, one
    whose bits read as a float NaN, one as NEG) and queries: hits, misses
    that share key_lo with an entry, and random misses. ``extra_bits``
    grows the table as the trainer's overflow policy does (512 buckets at
    0)."""
    rng = np.random.default_rng(seed + w)
    keys = rng.integers(0, 1 << 32, (n, w), dtype=np.int64)
    keys[0, 0] = 0x7FC00001
    keys[1, 0] = 0xF149F2CA
    valid = np.ones(n, bool)
    valid[-16:] = False
    la = rng.standard_normal(n).astype(np.float32)
    ph = rng.uniform(-3, 3, n).astype(np.float32)
    engine = PauliEngine(load_n2().qubit_ham, device=device,
                         membership="hash", hash_extra_bits=extra_bits)
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


def _assert_lookup_matches_plain(tab, q_lo, q_hi):
    """The kernel against its plain version, bit for bit (a gather and a
    select: no arithmetic on the values); returns the kernel's result."""
    launches = hash_lookup.launches, hash_tags.launches
    got = hash_lookup(tab, q_lo, q_hi)
    assert (hash_lookup.launches, hash_tags.launches) == (
        launches[0] + 1, launches[1] + 1)
    want = hash_lookup_plain(tab, q_lo, q_hi)
    torch.cuda.synchronize()
    for g, p in zip(got[:2], want[:2]):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))
    assert torch.equal(got[2], want[2])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("extra_bits", [0, 2, 3, 8])
def test_hash_lookup_matches_plain_on_card(cuda, w, extra_bits):
    """512 to 131072 buckets: tags staged in shared memory up to 2048
    buckets (extra_bits 2), read from global memory above."""
    tab, q_lo, q_hi = _hash_case(cuda, w, extra_bits=extra_bits)
    assert tab.shape[0] == 512 << extra_bits
    assert tags_in_shared_memory(tab.shape[0]) == (extra_bits <= 2)
    got = _assert_lookup_matches_plain(tab, q_lo, q_hi)
    assert 0 < int(got[2].sum()) < q_lo.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("extra_bits", [0, 8])
def test_hash_tags_match_plain_on_card(cuda, extra_bits):
    tab, _, _ = _hash_case(cuda, 2, n_queries=64, extra_bits=extra_bits)
    launches = hash_tags.launches
    tags = hash_tags(tab)
    assert hash_tags.launches == launches + 1
    assert torch.equal(tags, hash_tags_plain(tab))


def _hand_table(nb, entries):
    """An (nb, 128) table written slot by slot: ``entries`` maps (bucket,
    slot) to (key_lo, key_hi, log|psi|, phase); every other slot is empty
    (keys 0, log|psi| NEG)."""
    tab = torch.zeros((nb, ROW), dtype=torch.int32)
    tab[:, 2 * ENTRIES:3 * ENTRIES] = torch.tensor(
        NEG, dtype=torch.float32).view(torch.int32)
    for (b, e), (lo, hi, la, ph) in entries.items():
        tab[b, e] = int(np.uint32(lo).view(np.int32))
        tab[b, ENTRIES + e] = int(np.uint32(hi).view(np.int32))
        tab[b, 2 * ENTRIES + e] = torch.tensor(la).view(torch.int32)
        tab[b, 3 * ENTRIES + e] = torch.tensor(ph).view(torch.int32)
    return tab.view(torch.float32)


def _bucket(lo, hi, nb):
    return int(mix2(torch.tensor([lo]), torch.tensor([hi]))[0]) & (nb - 1)


def _queries(keys, device):
    q = torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32))
    return q[:, 0].contiguous().to(device), q[:, 1].contiguous().to(device)


def _layout_case(device, w, epb, extra_bits, n=4096, n_queries=1 << 18,
                 seed=11):
    """A bucket table of ``n`` random ``w``-word keys (a few invalid, one
    whose bits read as a float NaN) at ``hash_epb`` ``epb`` (None: the
    engine's default, 16 entries at w 3-4), and query columns: hits,
    misses that differ from an entry in one bit of the last word, and
    random misses. Returns (table, columns, entries a bucket)."""
    rng = np.random.default_rng(seed + 10 * w)
    ham = PauliHamiltonian(
        qubit_num=32 * w, constant=0.0, a_masks=np.zeros((1, w), np.uint32),
        b_words=np.zeros((1, w), np.uint32), weights=np.ones(1),
        group_starts=np.array([0, 1]))
    engine = PauliEngine(ham, device=device, membership="hash",
                         hash_epb=epb, hash_extra_bits=extra_bits)
    keys = rng.integers(0, 1 << 32, (n, w), dtype=np.int64)
    keys[0, 0] = 0x7FC00001
    valid = np.ones(n, bool)
    valid[-16:] = False
    la = rng.standard_normal(n).astype(np.float32)
    ph = rng.uniform(-3, 3, n).astype(np.float32)
    tab, _, overflow = engine._hash_build(
        *(torch.from_numpy(a).to(device) for a in (keys, la, ph, valid)))
    # 8-entry buckets at ~25% load overflow a few keys (JAX's hash_epb
    # note: a fatter Poisson tail); the comparison holds either way.
    assert int(overflow) <= 16
    q = keys[rng.integers(0, n, n_queries)]
    kind = rng.integers(0, 3, n_queries)
    q[kind == 1, w - 1] ^= 1 << 7
    q[kind == 2] = rng.integers(0, 1 << 32, (int((kind == 2).sum()), w))
    q = torch.from_numpy(q.astype(np.uint32).view(np.int32)).to(device)
    return tab, [q[:, j].contiguous() for j in range(w)], engine.hash_epb


@pytest.mark.cuda
@pytest.mark.parametrize("w,epb", [(2, 8), (2, 16), (3, None), (4, None)])
@pytest.mark.parametrize("extra_bits", [0, 3])
def test_hash_lookup_layouts_match_plain_on_card(cuda, w, epb, extra_bits):
    """The JAX engine's other bucket layouts: K 2 at E 8 and 16
    (``hash_epb``), K 3 and 4 at E 16, with the tags in shared memory
    (extra_bits 0: 16 KB) and in global memory (3: 128 KB): the lookup
    and the tag build bit for bit against their plain versions."""
    tab, cols, entries = _layout_case(cuda, w, epb, extra_bits)
    assert (tab.shape[1] // entries - 2, entries) in LAYOUTS
    assert tags_in_shared_memory(tab.shape[0], entries) == (extra_bits == 0)
    launches = hash_lookup.launches, hash_tags.launches
    got = hash_lookup(tab, *cols, entries=entries)
    assert (hash_lookup.launches, hash_tags.launches) == (
        launches[0] + 1, launches[1] + 1)
    want = hash_lookup_plain(tab, *cols, entries=entries)
    tags = hash_tags(tab, entries)
    torch.cuda.synchronize()
    for g, p in zip(got[:2], want[:2]):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))
    assert torch.equal(got[2], want[2])
    assert torch.equal(tags, hash_tags_plain(tab, entries))
    assert 0 < int(got[2].sum()) < cols[0].numel()


@pytest.mark.cuda
def test_hash_lookup_edges_on_card(cuda):
    """Hand-made tables: a bucket holding 32 live entries; two keys of one
    bucket and one tag; a key stored twice (the first slot wins) behind an
    empty slot holding it too; keys whose bits read as NaN or as NEG."""
    nb = 256
    rng = np.random.default_rng(17)
    cand = rng.integers(0, 1 << 32, (300_000, 2), dtype=np.int64)
    h = mix2(torch.from_numpy(cand[:, 0]), torch.from_numpy(cand[:, 1]))
    bucket = (h & (nb - 1)).numpy()
    tag = tag_of(h).numpy()
    full = np.flatnonzero(bucket == 5)[:32]  # 32 keys of bucket 5
    entries = {(5, e): (*cand[i], float(-e), float(e) / 10)
               for e, i in enumerate(full)}
    # Two keys of bucket 9 with one tag: only the second is stored.
    in9 = np.flatnonzero(bucket == 9)
    same = next(in9[tag[in9] == t] for t in tag[in9]
                if (tag[in9] == t).sum() >= 2)[:2]
    entries[(9, 4)] = (*cand[same[1]], -1.5, 0.25)
    # One key stored dead in slot 1, live in slots 3 and 7: slot 3 wins.
    dup = np.flatnonzero(bucket == 11)[0]
    entries[(11, 1)] = (*cand[dup], NEG, 9.0)
    entries[(11, 3)] = (*cand[dup], -2.0, 1.0)
    entries[(11, 7)] = (*cand[dup], -3.0, 2.0)
    # Keys whose bits read as a float NaN and as NEG, in their buckets.
    odd = [(0x7FC00001, 0xFFC00000), (0xF149F2CA, 0xF149F2CA),
           (0xF149F2CA, 0)]
    for e, (lo, hi) in enumerate(odd):
        entries[(_bucket(lo, hi, nb), 31 - e)] = (lo, hi, -0.5, -1.0)
    tab = _hand_table(nb, entries).to(cuda)
    keys = [*cand[full], cand[same[0]], cand[same[1]], cand[dup], *odd,
            (0x7FC00001, 0), (0, 0xF149F2CA), *cand[full] ^ (1 << 31)]
    q_lo, q_hi = _queries(keys, cuda)
    la, ph, found = _assert_lookup_matches_plain(tab, q_lo, q_hi)
    found = found.cpu().numpy()
    assert found[:32].all() and not found[32] and found[33]
    assert float(la[34]) == -2.0 and float(ph[34]) == 1.0
    assert found[35:38].all() and not found[38:].any()
    # One-word keys (q_hi None) against the same table's high-word-0 keys.
    _assert_lookup_matches_plain(tab, q_lo, None)


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


def _c2h4_batch(device, rows=1024, seed=3):
    """C2H4/6-31G's engine ('auto': prefilter membership, grouped order) and
    a canonically sorted two-word batch: random sector determinants, HF and
    its 64 largest-|me| partners (rows that couple to each other), all-ones
    sentinel rows at the end; amplitudes from a numpy seed."""
    from anqs_quantum_chemistry_torch.ops import keys
    from anqs_quantum_chemistry_torch.ops.bits import MASK32

    mol = load_c2h4()
    engine = PauliEngine(mol.qubit_ham, device=device)
    rng = np.random.default_rng(seed)
    dets = random_sector_dets(mol.n_orbitals, mol.n_alpha, mol.n_beta,
                              rows - 80, rng)
    hf = np.uint64(mol.hf_det)
    words = torch.from_numpy(np.stack(
        [dets & np.uint64(MASK32), dets >> np.uint64(32)], 1).astype(np.int64))
    hf_words = torch.tensor([[int(hf) & MASK32, int(hf) >> 32]]).to(device)
    me = engine.matrix_elements(hf_words)[0].abs()
    top = torch.argsort(me, descending=True, stable=True)[:64]
    words = torch.cat([words.to(device), hf_words, hf_words ^
                       engine.a_words[top],
                       torch.full((15, 2), MASK32, device=device)])
    valid = torch.ones(rows, dtype=torch.bool, device=device)
    valid[-15:] = False
    words, _, valid = keys.sort_words(words, valid)
    valid = valid & keys.unique_mask(words)
    la = torch.from_numpy(-np.abs(rng.standard_normal(rows)).astype(
        np.float32)).to(device)
    ph = torch.from_numpy(rng.uniform(-3, 3, rows).astype(np.float32)).to(
        device)
    return engine, words, la, ph, valid


@pytest.mark.cuda
def test_hash_lookup_matches_plain_on_card_c2h4_dense_rows(cuda):
    """Kernel #2 at two-word keys and the prefilter's dense-fallback shape
    on the C2H4 path: 256 rows x all 20776 groups = 5.3M queries."""
    engine, words, la, ph, valid = _c2h4_batch(cuda)
    tab, nb, overflow = engine._hash_build(words, la, ph, valid)
    assert int(overflow) == 0
    w32 = words[:256].to(torch.int64)
    q = (w32[:, None, :] ^ engine.a_words[None, :, :]).reshape(-1, 2)
    q = torch.where(q >= 1 << 31, q - (1 << 32), q).to(torch.int32)
    got = _assert_lookup_matches_plain(tab, q[:, 0].contiguous(),
                                       q[:, 1].contiguous())
    assert q.shape[0] == 256 * engine.n_groups
    assert int(got[2].sum()) > 256  # each row finds itself and partners


@pytest.mark.cuda
@pytest.mark.parametrize("capacities", [{}, dict(prefilter_row_capacity=4,
                                                 prefilter_dense_rows=32)])
def test_prefilter_matches_cpu_on_card(cuda, capacities):
    """Prefilter membership on the card (kernels #1 and #2) against the
    same engine on the CPU (plain versions) on a C2H4 batch: equal counts,
    e within 1e-6 of the largest |e|, t to atol 1e-6 + 4e-7 relative."""
    out = []
    for device in (cuda, torch.device("cpu")):
        engine, words, la, ph, valid = _c2h4_batch(device)
        engine = engine.with_capacities(**capacities)
        out.append(engine.local_energy_proxy(words, la, ph, valid))
    got, want = out
    for field in ("found_pairs", "pf_dropped_rows", "table_overflow"):
        assert int(getattr(got, field)) == int(getattr(want, field)), field
    assert int(got.found_pairs) > int(valid.sum())
    for field in ("e_re", "e_im", "t_re", "t_im"):
        g, w = getattr(got, field).cpu(), getattr(want, field)
        atol = (1e-6 * float(w.abs().max()) if field[0] == "e" else 1e-6)
        torch.testing.assert_close(g, w, rtol=4e-7 if field[0] == "t"
                                   else 0.0, atol=atol)


def _filter_case(device, w, epb, extra_bits, rows=2048, m=3001, seed=7):
    """An engine of ``m`` one-term groups on 32 W - 5 qubits (masks 0, XORs
    of two rows, random masks; M not a multiple of a block's groups), its
    fingerprint table over ``rows`` random rows with 32 all-ones sentinel
    rows (invalid, at the end), and the rows."""
    from anqs_quantum_chemistry_torch.ops.bits import MASK32

    rng = np.random.default_rng(seed + w)
    n = 32 * w - 5
    top = np.full(w, MASK32, np.int64)
    top[-1] = (1 << (n % 32)) - 1
    words = rng.integers(0, 1 << 32, (rows, w), dtype=np.int64) & top
    words[-32:] = MASK32
    pairs = rng.integers(0, rows - 32, (m // 2, 2))
    a = np.concatenate([
        np.zeros((1, w), np.int64), words[pairs[:, 0]] ^ words[pairs[:, 1]],
        rng.integers(0, 1 << 32, (m - 1 - m // 2, w), dtype=np.int64) & top])
    ham = PauliHamiltonian(
        qubit_num=n, constant=0.0, a_masks=a.astype(np.uint32),
        b_words=np.zeros((m, w), np.uint32), weights=np.ones(m),
        group_starts=np.arange(m + 1))
    engine = PauliEngine(ham, device=device, membership="prefilter",
                         hash_epb=epb, hash_extra_bits=extra_bits)
    x = torch.from_numpy(words).to(device)
    valid = torch.arange(rows, device=device) < rows - 32
    zeros = torch.zeros(rows, device=device)
    _, _, overflow, fptab = engine._hash_build(x, zeros, zeros, valid,
                                               with_fp=True)
    assert int(overflow) == 0
    return engine, x, fptab


def _assert_filter_matches_plain(fptab, words, a_cols):
    """Kernel #3 against its plain version on the same card operands: bit
    for bit, one launch; returns the mask."""
    launches = fp_filter.launches
    got = fp_filter(fptab, words, a_cols)
    want = fp_filter_plain(fptab, words, a_cols)
    torch.cuda.synchronize()
    assert fp_filter.launches == launches + 1
    bad = (got != want).any(dim=1)
    assert not bad.any(), (
        f"kernel #3 differs from its plain version in "
        f"{int((got != want).sum())} entries, rows "
        f"{torch.nonzero(bad)[:20, 0].tolist()}")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("w,epb", [(1, None), (1, 8), (2, 16), (3, None),
                                   (4, None)])
@pytest.mark.parametrize("extra_bits", [0, 2])
def test_fp_filter_matches_plain_on_card(cuda, w, epb, extra_bits):
    """Kernel #3 at W 1-4 and E 8, 16, 32, its table in shared memory (32
    KB) and, two bucket bits up (128 KB), probed in global memory; 2048
    rows with sentinels x 3001 groups: bit for bit."""
    engine, words, fptab = _filter_case(cuda, w, epb, extra_bits)
    nb, e = fptab.shape
    assert e == (epb or (32 if w <= 2 else 16))
    assert fp_in_shared_memory(nb, e) == (extra_bits == 0)
    hit = _assert_filter_matches_plain(fptab, words, engine.a_cols)
    assert hit[:-32, 0].all()  # mask 0: each row finds itself
    assert int(hit[:, 1:].sum()) >= engine.n_groups // 2


@functools.lru_cache(maxsize=None)
def _cr2_engine(device):
    """Cr2/SV's engine as the benchmark's ``cr2.prefilter`` cell runs it:
    prefilter in 128-row blocks (grouped order, W 3, E 16)."""
    return PauliEngine(load_cr2().qubit_ham, device=device, me_chunk=128,
                       pf_row_chunk=128, prefilter_row_capacity=1024,
                       prefilter_dense_rows=64)


def _cr2_batch(device, rows=1088, seed=5):
    """The Cr2 engine and a canonically sorted three-word batch of the
    cell's size: random (24, 24)-sector determinants, one of them with 64
    partners x ^ A_m, 16 all-ones sentinel rows at the end; amplitudes from
    a numpy seed."""
    from anqs_quantum_chemistry_torch.ops import keys
    from anqs_quantum_chemistry_torch.ops.bits import MASK32, pack

    engine = _cr2_engine(str(device))
    rng = np.random.default_rng(seed)
    n = rows - 80
    occ = np.zeros((n, 84), np.int64)
    for spin in (0, 1):
        orb = np.argsort(rng.random((n, 42)), axis=1)[:, :24]
        np.put_along_axis(occ, 2 * orb + spin, 1, axis=1)
    words = pack(torch.from_numpy(occ)).to(device)
    m_idx = torch.from_numpy(rng.choice(engine.n_groups, 64,
                                        replace=False)).to(device)
    words = torch.cat([words, words[:1] ^ engine.a_words[m_idx],
                       torch.full((16, 3), MASK32, device=device)])
    valid = torch.arange(rows, device=device) < rows - 16
    words, _, valid = keys.sort_words(words, valid)
    valid = valid & keys.unique_mask(words)
    la = torch.from_numpy(-np.abs(rng.standard_normal(rows)).astype(
        np.float32)).to(device)
    ph = torch.from_numpy(rng.uniform(-3, 3, rows).astype(np.float32)).to(
        device)
    return engine, words, la, ph, valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cr2", "c2h4"])
def test_fp_filter_matches_plain_on_card_paths(cuda, case):
    """Kernel #3 at the main paths' shapes, bit for bit: a Cr2 row block
    (its last 128 rows, sentinels among them, against the 1088-row set's
    nb 512 x E 16 table, 32 KB in shared memory; M 471,774) and the C2H4
    batch at its escalated table (nb 2048 x E 32, 256 KB: global memory)."""
    if case == "cr2":
        engine, words, la, ph, valid = _cr2_batch(cuda)
        block, ok = words[-128:], valid[-128:]
    else:
        engine, words, la, ph, valid = _c2h4_batch(cuda)
        engine = engine.with_capacities(hash_extra_bits=3)
        block, ok = words, valid
    _, nb, overflow, fptab = engine._hash_build(words, la, ph, valid,
                                                with_fp=True)
    assert int(overflow) == 0
    assert (nb, fptab.shape[1]) == ((512, 16) if case == "cr2"
                                    else (2048, 32))
    assert fp_in_shared_memory(nb, fptab.shape[1]) == (case == "cr2")
    hit = _assert_filter_matches_plain(fptab, block.contiguous(),
                                       engine.a_cols)
    assert int(hit.sum()) >= int(ok.sum())  # the diagonal group


@pytest.mark.cuda
def test_fp_filter_launches_on_card(cuda):
    """The main path goes through kernel #3: one Cr2 prefilter call over
    the cell's 1088 rows in 128-row blocks launches it 9 times, each with
    the table in shared memory, and runs no binary search; an N2 sector
    step launches it 0 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from anqs_quantum_chemistry_torch.experiments.vmc import main_path_vmc
    from anqs_quantum_chemistry_torch.utils import spans

    engine, words, la, ph, valid = _cr2_batch(cuda)
    with torch.no_grad():
        engine.local_energy_proxy(words, la, ph, valid)
        launches = fp_filter.launches
        with spans.recording() as rec:
            engine.local_energy_proxy(words, la, ph, valid)
        assert fp_filter.launches == launches + 9
        counts = rec.summary(1)["fp_filter"]["counts"]
        assert counts["fp_launches"] == counts["fp_smem_launches"] == 9
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.local_energy_proxy(words, la, ph, valid)
            torch.cuda.synchronize()
    kernels = {ev.key: ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    assert sum(n for k, n in kernels.items() if "fp_filter_kernel" in k) == 9
    assert not [k for k in kernels if "searchsorted" in k], kernels

    vmc = main_path_vmc(device="cuda")
    state = vmc.init_state()
    launches = fp_filter.launches
    vmc.step(state)
    assert fp_filter.launches == launches


@pytest.mark.cuda
def test_spin_flip_step_on_card(cuda):
    """One N2 main-path step with both spin-flip flags and the flip closure
    on the card: kernel #1 launches once, every sector row stays in the
    set, and the energy is finite and within 1e-4 Ha of the same step's
    Rayleigh quotient (the float64 sector H over the step's own set)."""
    from anqs_quantum_chemistry_torch.chem.fci import sector_hamiltonian
    from anqs_quantum_chemistry_torch.experiments.vmc import main_path_vmc

    vmc = main_path_vmc(device="cuda", couple_spin_flip=True,
                        anqs_options=dict(spin_flip_abs=True,
                                          spin_flip_phase=True))
    state = vmc.init_state()
    gen = state.generator.get_state()
    words, _, valid, _, la, ph, _ = vmc._support_and_eloc(state)
    state.generator.set_state(gen)
    fused_matrix_elements.launches = 0
    row = vmc.step(state)
    assert fused_matrix_elements.launches == 1
    mol = vmc.mol
    assert int(row["unique_num"]) == mol.fci_ndet
    keep = valid.cpu().numpy()
    dets = words[:, 0].cpu().numpy().astype(np.uint64)[keep]
    psi = np.exp(la.double().cpu().numpy()[keep]
                 + 1j * ph.double().cpu().numpy()[keep])
    order = np.argsort(dets)
    dets, psi = dets[order], psi[order]
    h = sector_hamiltonian(vmc.ham, dets)
    e_ref = float(np.real(np.vdot(psi, h @ psi)) / np.vdot(psi, psi).real)
    assert np.isfinite(row["energy"])
    assert abs(row["energy"] - e_ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gumbel", "counts"])
def test_exact_top_k_matches_ordered_top_k_on_card(cuda, case):
    """``exact_top_k`` on the card against the ordered top-k (a stable
    descending sort) bit for bit, at the Li2O sampler's last frontier
    (8192 rows x 64 continuations, top 8192): Gumbel keys, 99% NEG fill
    (the top k reaches the NEG ties),
    and integer counts with mass ties."""
    from anqs_quantum_chemistry_torch.ops.topk import exact_top_k
    from anqs_quantum_chemistry_torch.sampling.sampler import _top_k

    gen = torch.Generator(device=cuda).manual_seed(0)
    n, k = 8192 * 64, 8192
    if case == "gumbel":
        x = torch.randn(n, generator=gen, device=cuda)
        x = torch.where(torch.rand(n, generator=gen, device=cuda) < 0.01,
                        x, -1e30)
    else:
        x = torch.randint(0, 5, (n,), generator=gen, device=cuda)
    v, i = exact_top_k(x, k)
    sv, si = _top_k(x, k)
    assert torch.equal(i, si) and torch.equal(v, sv)


@pytest.mark.cuda
def test_hash_dist_one_nccl_rank_matches_hash_on_card(cuda):
    """'hash_dist' on a one-rank NCCL mesh (a spawned rank, the dry run's
    ``li2o`` leg): the Li2O toy model's local energies equal one process's
    'hash' bit for bit, kernel #2 answering on the rank's one shard."""
    from anqs_quantum_chemistry_torch.experiments.dryrun_multichip import (
        launch,
    )

    (report,) = launch(((1, ("li2o",)),), "nccl", "cuda")
    launches = report[1]["li2o"]["launches"]
    assert launches["hash_lookup"] >= 1 and launches["hash_tags"] >= 1
    assert launches["fused_matrix_elements"] == 1


@pytest.mark.cuda
def test_step_cost_matches_cpu_on_card(cuda):
    """``step_cost_analysis`` of the N2 sector configuration (the main
    path, ``bench.py``'s headline) on the card against the same trainer on
    the CPU: the matmul-class flops (the backward of the loss and MinSR's
    ``jacrev`` among them, which run on autograd's device thread on the
    card) and the three kernels' entries equal, the totals within 1%
    (each total's relative gap printed)."""
    from anqs_quantum_chemistry_torch.experiments.vmc import main_path_vmc
    from anqs_quantum_chemistry_torch.utils import cost

    card = main_path_vmc(device="cuda").step_cost_analysis()
    host = main_path_vmc(device="cpu").step_cost_analysis()
    assert card["device"] == "cuda" and host["device"] == "cpu"
    assert cost.matmul_flops(card["by_source"]) == cost.matmul_flops(
        host["by_source"]) > 0
    for source, entry in host["by_source"].items():
        if entry["kind"] in ("matmul", "kernel"):
            assert card["by_source"][source] == entry, source
    assert card["by_source"]["fused_matrix_elements"]["calls"] == 1
    for key in ("flops", "transcendentals", cost.BYTES):
        print(f"{key}: card {card[key]} cpu {host[key]} relative gap "
              f"{(card[key] - host[key]) / host[key]:.3e}")
        assert abs(card[key] - host[key]) <= 0.01 * host[key], key


@pytest.mark.cuda
def test_profile_stages_on_card(cuda, monkeypatch):
    """``profile_stages`` on the card times with CUDA events: the host
    clock is never read (it raises here), every sampled-branch key is
    there, and each time is positive."""
    from anqs_quantum_chemistry_torch.experiments import vmc as vmc_mod

    vmc = vmc_mod.main_path_vmc(device="cuda")

    def no_host_clock():
        raise AssertionError("profile_stages read the host clock")

    monkeypatch.setattr(vmc_mod.time, "perf_counter", no_host_clock)
    res = vmc.profile_stages(reps=2)
    assert res.pop("device") == "cuda"
    assert set(res) == {"sample_ms", "sort_ms", "log_psi_ms",
                        "matrix_elements_ms", "local_energy_ms", "grad_ms",
                        "sr_ms"}
    assert all(v > 0 for v in res.values()), res


PREFILTER_REPEATS = 20


def _recorded(engine, log):
    """Wrap the engine's prefilter stages so that each call appends its
    inputs and outputs (the real path's intermediates) to ``log``."""
    def wrap(name, fn, keep_args=()):
        def call(*args):
            out = fn(*args)
            outs = out if isinstance(out, tuple) else (out,)
            log.append((name, [args[i] for i in keep_args if i < len(args)]
                        + [o for o in outs if isinstance(o, torch.Tensor)]))
            return out
        return call

    # Stage 1 (the fingerprint hits), stage 2 (the kept groups, m_idx, in
    # the 3a lookups' arguments; kvals > 0 in the 3a sums' found), the
    # lookups of 3a and 3b, kernel #1, the sums of 3a and 3b, the dense
    # rows.
    engine._fp_candidates = wrap("stage1 hits", engine._fp_candidates)
    engine._lookup_rows = wrap("lookups (m_idx, la, ph, found)",
                               engine._lookup_rows, keep_args=(2,))
    engine.matrix_elements = wrap("kernel #1", engine.matrix_elements)
    engine._combine_rows = wrap("row sums (me, la, ph, found, sums)",
                                engine._combine_rows, keep_args=(0, 1, 2, 3))
    engine._dense_rows = wrap("dense rows", engine._dense_rows)
    return engine


def _bits(t):
    """A float tensor's bit patterns (so that -0.0 and NaN compare too)."""
    if not t.is_floating_point():
        return t
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


@pytest.mark.cuda
def test_prefilter_repeats_bit_for_bit_on_card(cuda):
    """The C2H4 prefilter batch of ``test_prefilter_matches_cpu_on_card``
    evaluated ``PREFILTER_REPEATS`` times in one process: each run equals
    the first bit for bit, stage by stage (stage-1 hits, stage 2's kept
    groups, the 3a and 3b lookups, kernel #1, the 3a and dense sums, the
    dense rows), then e and t; and kernel #1 on the batch equals its plain
    version every time. A mismatch names the stage, the call and the rows
    that moved."""
    engine, words, la, ph, valid = _c2h4_batch(cuda)
    first, first_out = None, None
    plain = matrix_elements_plain(words, engine.me_tables)
    for rep in range(PREFILTER_REPEATS):
        log = []
        eng = _recorded(engine.with_capacities(), log)
        out = eng.local_energy_proxy(words, la, ph, valid)
        me = fused_matrix_elements(words, engine.me_tables)
        torch.cuda.synchronize()
        bad = (me != plain).any(dim=1)
        assert not bad.any(), (
            f"repeat {rep}: kernel #1 differs from its plain version in "
            f"rows {torch.nonzero(bad)[:20, 0].tolist()}")
        if first is None:
            first, first_out = log, out
            assert len(log) >= 6
            continue
        assert [name for name, _ in log] == [name for name, _ in first]
        for call, ((name, got), (_, want)) in enumerate(zip(log, first)):
            for j, (g, w) in enumerate(zip(got, want)):
                diff = _bits(g) != _bits(w)
                if diff.any():
                    rows = torch.nonzero(diff.reshape(diff.shape[0], -1)
                                         .any(dim=1))[:20, 0].tolist()
                    raise AssertionError(
                        f"repeat {rep}: {name} (call {call}, tensor {j}) "
                        f"moved in {int(diff.sum())} entries, rows {rows}")
        for field in ("found_pairs", "pf_dropped_rows", "table_overflow",
                      "e_re", "e_im", "t_re", "t_im"):
            g, w = getattr(out, field), getattr(first_out, field)
            assert torch.equal(_bits(torch.as_tensor(g)),
                               _bits(torch.as_tensor(w))), (rep, field)


@pytest.mark.cuda
def test_spans_count_host_syncs_on_card(cuda):
    """A recorded N2 step (the main path) on the card: the step makes
    synchronizing calls, each put down to an open span (the read-back to
    ``vmc.update``), device ms by CUDA events, and the sync debug mode
    back at its setting afterwards."""
    from anqs_quantum_chemistry_torch.experiments.vmc import main_path_vmc
    from anqs_quantum_chemistry_torch.utils import spans

    vmc = main_path_vmc(device="cuda")
    state = vmc.init_state()
    vmc.step(state)
    mode = torch.cuda.get_sync_debug_mode()
    with spans.recording() as rec:
        vmc.step(state)
    assert torch.cuda.get_sync_debug_mode() == mode
    assert rec.cuda and rec.steps == 1
    summary = rec.summary(1)
    syncs = sum(e["syncs"] for e in summary.values())
    print({name: e["syncs"] for name, e in summary.items() if e["syncs"]})
    assert syncs > 0 and summary["vmc.update"]["syncs"] >= 1
    step = summary["vmc.step"]
    assert 0 < step["device_ms"] and step["self_ms"] <= step["device_ms"]


@pytest.mark.cuda
def test_graphed_decode_matches_eager_on_card(cuda, monkeypatch):
    """The cached Gumbel draw on the card, whose decode steps replay one
    CUDA graph a (qudit, rows), draws what the same draw with each decode
    run eagerly draws, from the same uniforms -- again after an in-place
    update of the weights, which the graphs read where they lie; a new
    parameter storage brings a new cache and new graphs."""
    from anqs_quantum_chemistry_torch.experiments.preparation import (
        create_masker,
    )
    from anqs_quantum_chemistry_torch.models.anqs import ANQS, AnqsConfig
    from anqs_quantum_chemistry_torch.models.transformer import DecodeCache
    from anqs_quantum_chemistry_torch.sampling.sampler import (
        gumbel_top_k_sample,
        uniform_shapes,
    )
    from anqs_quantum_chemistry_torch.symmetries import QubitGrouping

    anqs = ANQS(QubitGrouping.create(create_masker(load_n2(), "e_num_spin"),
                                     4),
                AnqsConfig(net_type="transformer", d_model=16, n_layers=2,
                           n_heads=2, d_ff=32, logit_cap=4.0),
                generator=torch.Generator().manual_seed(4)).to(cuda)
    k, gen = 64, torch.Generator(device=cuda).manual_seed(3)
    graphed = DecodeCache.replay

    def eager(cache, net, prev, q):
        return net._decode(cache, prev, q)

    def both():
        us = [torch.clamp(torch.rand(s, generator=gen, device=cuda),
                          min=1e-38) for s in uniform_shapes(anqs, k)]
        monkeypatch.setattr(DecodeCache, "replay", graphed)
        a = gumbel_top_k_sample(anqs, k, uniforms=us)
        monkeypatch.setattr(DecodeCache, "replay", eager)
        b = gumbel_top_k_sample(anqs, k, uniforms=us)
        assert torch.equal(a.words, b.words)
        assert torch.equal(a.valid, b.valid) and int(a.valid.sum()) == k
        torch.testing.assert_close(a.log_probs, b.log_probs, rtol=1e-6,
                                   atol=1e-6)

    both()
    cache = anqs.main._decode_cache
    assert len(cache._graphs) == anqs.qudit_num
    with torch.no_grad():
        for p in anqs.parameters():
            p.add_(0.05 * torch.randn_like(p))
    both()
    assert anqs.main._decode_cache is cache
    assert len(cache._graphs) == anqs.qudit_num
    anqs.main.head = torch.nn.Parameter(anqs.main.head.detach().clone())
    both()
    assert anqs.main._decode_cache is not cache
