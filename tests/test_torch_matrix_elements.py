"""Matrix elements and sector local energies of the PyTorch port against the
JAX package.

The port's plain version (``matrix_elements_plain``, the path its wrapper
takes for CPU tensors) is held against the JAX ``'split'`` path and the
Pallas kernel in interpret mode, as ``tests/test_pallas_kernels.py`` runs
it, at atol 1e-6 Ha. The CUDA kernel itself runs only on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from anqs_quantum_chemistry_tpu.chem.jw import (
    PauliHamiltonian as JaxPauliHamiltonian,
)
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
from anqs_quantum_chemistry_torch.chem.fci import (
    random_sector_dets,
    sector_determinants,
    sector_matrix_elements,
)
from anqs_quantum_chemistry_torch.chem.molecule import load_c2h4
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops import bits as tbits
from anqs_quantum_chemistry_torch.ops import matrix_elements as mx
from anqs_quantum_chemistry_torch.ops.matrix_elements import (
    fused_matrix_elements,
    matrix_elements_plain,
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


@pytest.mark.parametrize("name,kind", [("H2O", "random"), ("N2", "sector")])
@pytest.mark.parametrize("term_chunk", [1, 7, 100])
def test_chunked_plain_equals_dense(rng, monkeypatch, name, kind,
                                    term_chunk):
    """The group-chunked plain version against the unchunked dense form
    (one (3, T, M) one-hot, the plain version before chunking), bit for
    bit: float64 sums of +-bf16 values are exact, whatever the chunks."""
    _, mol = molecules(name)
    tables = PauliEngine(mol.qubit_ham, device="cpu").me_tables
    words = torch.from_numpy(_sources(rng, mol, kind))
    b_bits, group_splits = plain_operands(tables)
    x = tbits.unpack(words, mol.qubit_num, dtype=torch.float32)
    sign = (1.0 - 2.0 * torch.remainder(x @ b_bits, 2.0)).double()
    parts = [(sign @ g.double()).float() for g in group_splits]
    dense = (parts[0] + parts[1]) + parts[2]
    monkeypatch.setattr(mx, "PLAIN_TERM_CHUNK", term_chunk)
    got = matrix_elements_plain(words, tables)
    assert torch.equal(got, dense)


def _walk_segments(starts, kern):
    """Follow the kernel's control flow over every tile's warp segments
    (``csrc/fused_me.cu``): count how often each term is summed and each
    group's stage column is written, and which groups go through each cut
    slot. Returns (term counts, stage writes, {(tile, slot): groups}, the
    (tile, slot) pairs that their owners round)."""
    tiles = kern.tile_starts.numpy().astype(np.int64)
    segments = kern.segments.numpy().astype(np.int64)
    terms = np.zeros(starts[-1], np.int64)
    writes = np.zeros(len(starts) - 1, np.int64)
    slots, rounded = {}, set()
    for i, (m0, _) in enumerate(tiles[:-1]):
        n_cols = tiles[i + 1, 0] - m0
        g = starts[m0:m0 + n_cols + 1]
        for warp, (s0, s1, first, w) in enumerate(segments[i]):
            head, tail = w & 0xFFFF, w >> 16
            if s0 >= s1:
                continue
            m = first
            while True:
                g_lo, g_hi = g[m], g[m + 1]
                terms[max(g_lo, s0):min(g_hi, s1)] += 1
                if g_lo >= s0 and g_hi <= s1:
                    writes[m0 + m] += 1
                else:
                    slot = head if m == first else tail
                    slots.setdefault((i, slot), set()).add(m0 + m)
                if g_hi >= s1 or m + 1 >= n_cols:
                    break
                m += 1
            if g[first] < s0 and head == warp:  # the owner rounds its slot
                writes[m0 + first] += 1
                rounded.add((i, warp))
                assert slots[(i, warp)] == {m0 + first}
    return terms, writes, slots, rounded


def _one_long_group_ham(rng):
    """N2's tables with one group stretched to 1000 terms (its terms
    repeated), so that a single group spans many warp segments."""
    h = molecules("N2")[1].qubit_ham
    starts = np.asarray(h.group_starts, np.int64)
    sizes = np.diff(starts)
    m = int(rng.integers(len(sizes)))
    take = np.concatenate([
        np.arange(starts[m]),
        starts[m] + np.arange(1000) % sizes[m],
        np.arange(starts[m + 1], starts[-1]),
    ])
    sizes[m] = 1000
    return dataclasses.replace(
        h,
        b_words=np.asarray(h.b_words)[take],
        weights=np.asarray(h.weights)[take],
        group_starts=np.concatenate([[0], np.cumsum(sizes)]),
    )


@pytest.mark.parametrize("name", ["N2", "C2H4", "long group"])
def test_kernel_tables(rng, name):
    """The kernel's operands: every term's record holds its three splits
    as float64 and its sign-mask words; tiles are runs of consecutive
    groups within the kernel's limits; each tile's warp segments cover its
    terms once, every group's column is written once, and each group cut
    between segments goes through one slot, which its owner rounds."""
    if name == "long group":
        h = _one_long_group_ham(rng)
    else:
        h = (load_c2h4() if name == "C2H4" else molecules(name)[1]).qubit_ham
    starts = np.asarray(h.group_starts, np.int64)
    splits = mx.bf16_splits(torch.from_numpy(
        np.asarray(h.weights).astype(np.float32)))
    kern = mx.kernel_operands(h, splits, starts, "cpu")
    assert mx.build_tables(h, "cpu").kernel is None  # the CPU never reads it
    rec = kern.records.numpy().view(np.uint64)
    n_words = h.b_words.shape[1]
    assert rec.shape == (h.n_terms, 4)
    np.testing.assert_array_equal(
        rec[:, :3].view(np.float64), splits.double().T.numpy()
    )
    b = np.asarray(h.b_words).astype(np.uint64)
    for j in range(n_words):
        np.testing.assert_array_equal(
            (rec[:, 3] >> np.uint64(32 * j)) & np.uint64(0xFFFFFFFF), b[:, j]
        )
    tiles, tile_terms = kern.tile_starts.numpy().astype(np.int64).T
    np.testing.assert_array_equal(tile_terms, starts[tiles])
    assert tiles[0] == 0 and tiles[-1] == h.n_groups
    groups = np.diff(tiles)
    terms = starts[tiles[1:]] - starts[tiles[:-1]]
    assert np.all(groups >= 1) and np.all(groups <= mx.TILE_GROUPS)
    assert np.all((terms <= mx.TILE_TERMS) | (groups == 1))
    assert kern.segments.shape == (len(tiles) - 1, mx.SEG_WARPS, 4)
    summed, writes, slots, rounded = _walk_segments(starts, kern)
    assert np.all(summed == 1) and np.all(writes == 1)
    assert all(len(cut) == 1 for cut in slots.values())
    assert set(slots) == rounded
    if name != "C2H4":
        assert slots  # some group is cut between segments


@pytest.mark.parametrize("name", ["N2", "Li2O", "C2H4", "TFI-64"])
def test_kernel_partition_of_path_tables(name):
    """Kernel #1's write rule (``csrc/fused_me.cu``: whole groups into the
    stage by the warp that sums them, cut groups through a slot that the
    owner rounds) over the tables each path hands the kernel, in the
    engine's group order (``PauliEngine.me_tables``): N2, Li2O, C2H4/6-31G
    (the 'grouped' order) and the open TFI chain at 64 sites. Every term
    of every tile is summed once and every group's stage column written
    once -- a column no warp wrote would be stored from leftover shared
    memory -- and each cut group's partial sums go to one slot, the one
    its rounding warp reads."""
    from anqs_quantum_chemistry_torch.applications.spin_systems import (
        tfi_hamiltonian,
    )
    from anqs_quantum_chemistry_torch.chem.molecule import load_li2o, load_n2

    ham = {"N2": lambda: load_n2().qubit_ham,
           "Li2O": lambda: load_li2o().qubit_ham,
           "C2H4": lambda: load_c2h4().qubit_ham,
           "TFI-64": lambda: tfi_hamiltonian(64)}[name]()
    tables = PauliEngine(ham, device="cpu").me_tables
    starts = tables.group_starts.numpy().astype(np.int64)
    kern = mx.kernel_operands(dataclasses.make_dataclass(
        "Words", ["b_words"])(tables.b_words.numpy()), tables.splits,
        starts, "cpu")
    summed, writes, slots, rounded = _walk_segments(starts, kern)
    assert summed.shape == (tables.splits.shape[1],)
    assert np.all(summed == 1) and np.all(writes == 1)
    assert all(len(cut) == 1 for cut in slots.values())
    assert set(slots) == rounded


def test_c2h4_plain_matches_jax():
    """C2H4/6-31G (52 qubits: two words a determinant; 104278 terms in
    20776 groups) at 16 random determinants of its (8, 8) sector: the
    plain version against the JAX engine's matrix elements in the form its
    'auto' picks ('grouped', which reorders the groups by size class; the
    port's engine takes the same group order), and against the float64
    host reference, its columns matched by each group's flip mask. The JAX
    engine gets the Hamiltonian from the port's packaged arrays."""
    mol = load_c2h4()
    h = mol.qubit_ham
    jham = JaxPauliHamiltonian(
        qubit_num=h.qubit_num, constant=h.constant, a_masks=h.a_masks,
        b_words=h.b_words, weights=h.weights, group_starts=h.group_starts,
    )
    jeng = JaxPauliEngine(jham)
    assert jeng.weights_matmul == "grouped"
    dets = random_sector_dets(mol.n_orbitals, mol.n_alpha, mol.n_beta, 16,
                              np.random.default_rng(11))
    words = np.stack([dets & np.uint64(0xFFFFFFFF), dets >> np.uint64(32)],
                     axis=1).astype(np.int64)
    want = np.asarray(jeng.matrix_elements(jnp.asarray(words, jnp.uint32)))
    eng = PauliEngine(h, device="cpu")
    got = eng.matrix_elements(torch.from_numpy(words)).numpy()
    assert got.shape == want.shape == (16, h.n_groups)
    np.testing.assert_array_equal(eng.a_words.numpy(),
                                  np.asarray(jeng.a_words).astype(np.int64))
    column = {tuple(a): m for m, a in enumerate(np.asarray(h.a_masks))}
    order = [column[tuple(a)] for a in np.asarray(jeng.a_words)]
    # 'grouped' sums a group's products in float32: over the 1378-term
    # diagonal group (flip mask 0) its partial sums reach tens of Ha and it
    # strays up to 3.8e-6 Ha from the float64 sum, so that group is held
    # at 1e-5 Ha and every other at 1e-6. The port's float64 sums stay
    # within one float32 ulp of the float64 host reference everywhere.
    diagonal = np.all(np.asarray(jeng.a_words) == 0, axis=1)
    assert diagonal.sum() == 1
    np.testing.assert_allclose(got[:, ~diagonal], want[:, ~diagonal],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, diagonal], want[:, diagonal], rtol=0,
                               atol=1e-5)
    ref = sector_matrix_elements(h, dets)[:, order]
    assert np.all(np.abs(got - ref) <= 1e-6 + 2.4e-7 * np.abs(ref))


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
