"""Spin chains on the PyTorch port against the JAX package: the containers
of ``applications/spin_systems.py`` (0 ulp), the complex dense oracle and
the exact energies (1e-10), local energies with the odd-Y phase channel
over the full basis of the 6-site XY+DM chain (1e-5 against JAX, 2e-4
against the dense oracle, as JAX ``tests/test_spin_systems.py:130-188``
asserts), the engine's refusals, and one VMC step on an explicit
Hamiltonian for each training configuration of ``chip_smoke.py``'s spin
phase (energy and variance to 1e-6, gradients rtol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.applications import spin_systems as jss
from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models.anqs import ANQS as JaxANQS
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.observables.pauli import (
    PauliEngine as JaxPauliEngine,
)
from anqs_quantum_chemistry_tpu.ops import bits as jbits
from anqs_quantum_chemistry_tpu.ops import keys as jkeys
from anqs_quantum_chemistry_tpu.symmetries import Masker as JaxMasker
from anqs_quantum_chemistry_tpu.symmetries import QubitGrouping as JaxGrouping
from anqs_quantum_chemistry_tpu.symmetries import (
    idle_symmetry as jax_idle_symmetry,
)
from anqs_quantum_chemistry_tpu.symmetries import (
    particle_number_symmetry as jax_particle_number_symmetry,
)
from anqs_quantum_chemistry_torch.applications import spin_systems as ss
from anqs_quantum_chemistry_torch.chem.jw import permute_qubits_hamiltonian
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import ANQS, AnqsConfig
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops.matrix_elements import (
    build_tables,
    matrix_elements_plain,
)
from anqs_quantum_chemistry_torch.symmetries import (
    Masker,
    QubitGrouping,
    idle_symmetry,
    particle_number_symmetry,
)
from torch_port_common import to_np
from torch_step_common import assert_step_matches, step_pair_explicit

FIELDS = ("constant", "a_masks", "b_words", "weights", "group_starts",
          "phase_offsets")


def _jax_dm_chain(n, jxy=1.0, d=0.6):
    """JAX ``tests/test_spin_systems.py``'s ``_dm_chain``."""
    terms = []
    for i in range(n - 1):
        terms.append(({i: "X", i + 1: "X"}, jxy))
        terms.append(({i: "Y", i + 1: "Y"}, jxy))
        terms.append(({i: "X", i + 1: "Y"}, d))
        terms.append(({i: "Y", i + 1: "X"}, -d))
    return jss.pauli_sum(n, terms)


# (port constructor, JAX constructor) of each container under test.
CONTAINERS = {
    "lone_y": (lambda m: m.pauli_sum(2, [({0: "Y"}, 1.0)]),
               lambda m: m.pauli_sum(2, [({0: "Y"}, 1.0)])),
    "yy": (lambda m: m.pauli_sum(3, [({0: "Y", 2: "Y"}, 0.7)], 0.25),
           lambda m: m.pauli_sum(3, [({0: "Y", 2: "Y"}, 0.7)], 0.25)),
    "dm_chain": (lambda m: ss.dm_chain_hamiltonian(7, 1.0, 0.6),
                 lambda m: _jax_dm_chain(7, 1.0, 0.6)),
    "xxz": (lambda m: m.heisenberg_xxz_hamiltonian(8, 1.0, 0.5, True),
            lambda m: m.heisenberg_xxz_hamiltonian(8, 1.0, 0.5, True)),
    "tfi": (lambda m: m.tfi_hamiltonian(10, 1.0, 0.8),
            lambda m: m.tfi_hamiltonian(10, 1.0, 0.8)),
    "tfi_64": (lambda m: m.tfi_hamiltonian(64),
               lambda m: m.tfi_hamiltonian(64)),
}


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_containers_match_jax(name):
    port, jax_build = CONTAINERS[name]
    ham, jham = port(ss), jax_build(jss)
    assert ham.qubit_num == jham.qubit_num
    for field in FIELDS:
        got, want = getattr(ham, field), getattr(jham, field)
        if want is None:
            assert got is None, field
            continue
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)


def test_dm_chain_shape():
    """Per bond one real group (XX + YY) and one imaginary group (XY, YX)
    on the same flip mask: DM-40 has 78 groups of 2 terms."""
    ham = ss.dm_chain_hamiltonian(40)
    assert (ham.n_groups, ham.n_terms) == (78, 156)
    assert np.array_equal(ham.a_masks[0::2], ham.a_masks[1::2])
    np.testing.assert_array_equal(ham.phase_offsets,
                                  np.tile([0.0, np.pi / 2], 39))


def test_dense_oracle_matches_jax():
    ham, jham = ss.dm_chain_hamiltonian(4), _jax_dm_chain(4)
    for x in range(16):
        for y in range(16):
            got = ham.dense_matrix_element(x, y)
            assert isinstance(got, complex)
            assert got == jham.dense_matrix_element(x, y), (x, y)
    lone_y = ss.pauli_sum(2, [({0: "Y"}, 1.0)])
    assert abs(lone_y.dense_matrix_element(0, 1) - 1j) < 1e-12  # <1|Y|0>
    assert abs(lone_y.dense_matrix_element(1, 0) + 1j) < 1e-12
    real = ss.tfi_hamiltonian(4)
    assert isinstance(real.dense_matrix_element(0, 1), float)


@pytest.mark.parametrize("name", ["lone_y", "yy", "xxz", "tfi"])
def test_exact_ground_energy_matches_jax(name):
    port, jax_build = CONTAINERS[name]
    assert abs(ss.exact_ground_energy(port(ss))
               - jss.exact_ground_energy(jax_build(jss))) < 1e-10


def test_exact_ground_energy_dm_and_limit():
    assert abs(ss.exact_ground_energy(ss.dm_chain_hamiltonian(6))
               - jss.exact_ground_energy(_jax_dm_chain(6))) < 1e-10
    with pytest.raises(ValueError):
        ss.exact_ground_energy(ss.tfi_hamiltonian(15))


def test_permute_carries_phase_offsets():
    """Relabelled qubits keep each group's phase: every element of the
    permuted DM chain equals the original's at the relabelled bits."""
    n = 5
    ham = ss.dm_chain_hamiltonian(n)
    perm = [3, 0, 4, 1, 2]
    pham = permute_qubits_hamiltonian(ham, perm)

    def relabel(x):
        return sum(((x >> p) & 1) << i for i, p in enumerate(perm))

    for x in range(1 << n):
        for y in range(1 << n):
            assert abs(pham.dense_matrix_element(relabel(x), relabel(y))
                       - ham.dense_matrix_element(x, y)) < 1e-12


def test_plain_elements_on_duplicate_masks():
    """Kernel #1's plain version on a table where two groups share each
    flip mask (and TFI's one-term groups): each column is the real part
    e^(-i off) <x ^ A_m|H_m|x> of the group's own terms, whatever its
    twin holds."""
    for ham in (ss.dm_chain_hamiltonian(6), ss.tfi_hamiltonian(6)):
        tables = build_tables(ham, "cpu")
        x = torch.arange(64, dtype=torch.int64)[:, None]
        me = matrix_elements_plain(x, tables).numpy()
        b = [int(w[0]) for w in ham.b_words]
        for m in range(ham.n_groups):
            s, e = ham.group_starts[m], ham.group_starts[m + 1]
            for xi in range(64):
                want = sum(ham.weights[t] * (-1.0) ** bin(xi & b[t]).count(
                    "1") for t in range(s, e))
                assert abs(me[xi, m] - want) < 1e-6, (m, xi)


def _dm6_basis():
    """The 6-site DM chain, its full basis sorted, and (JAX ANQS, params,
    port ANQS with those weights) at qubit_per_qudit 2, MADE 32 (JAX's
    test's net), seed 3."""
    n = 6
    bits = np.array([[(x >> i) & 1 for i in range(n)] for x in range(1 << n)])
    sw, _ = jkeys.sort_words(jbits.pack(jnp.asarray(bits)))
    jgrouping = JaxGrouping.create(JaxMasker([jax_idle_symmetry(n)]), 2)
    janqs = JaxANQS(jgrouping, JaxAnqsConfig(hidden_widths=(32,)))
    params = janqs.init(jax.random.PRNGKey(3))
    anqs = ANQS(QubitGrouping.create(Masker([idle_symmetry(n)]), 2),
                AnqsConfig(hidden_widths=(32,)))
    anqs.load_state_dict(params_from_jax(to_np(params)))
    return sw, janqs, params, anqs


def _dm_dense(n, jxy=1.0, d=0.6):
    """The XY+DM chain as a dense complex matrix from Kronecker products
    (qubit 0 the least significant bit)."""
    sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    sy = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)

    def at(op, i):
        out = np.eye(1, dtype=np.complex128)
        for j in reversed(range(n)):
            out = np.kron(out, op if j == i else np.eye(2))
        return out

    mat = np.zeros((1 << n, 1 << n), dtype=np.complex128)
    for i in range(n - 1):
        mat += jxy * (at(sx, i) @ at(sx, i + 1) + at(sy, i) @ at(sy, i + 1))
        mat += d * (at(sx, i) @ at(sy, i + 1) - at(sy, i) @ at(sx, i + 1))
    return mat


ENGINES = {"search": dict(membership="search"),
           "table": dict(membership="table"),
           "hash": dict(membership="hash"),
           "grouped": dict(membership="table", weights_matmul="grouped")}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_dm6_local_energies(name):
    sw, janqs, params, anqs = _dm6_basis()
    ham, jham = ss.dm_chain_hamiltonian(6), _jax_dm_chain(6)
    la, ph = janqs.log_psi(params, sw)
    valid = jnp.ones((sw.shape[0],), bool)
    jkw = dict(ENGINES[name])
    if jkw["membership"] == "table":
        jkw["table_pairs_per_row"] = 1
    je = JaxPauliEngine(jham, **jkw).local_energy_proxy(sw, la, ph, valid)
    eng = PauliEngine(ham, device="cpu", **ENGINES[name])
    assert eng.group_phase is not None
    words = torch.from_numpy(np.asarray(sw).astype(np.int64))
    with torch.no_grad():
        pla, pph = anqs.log_psi(words)
    np.testing.assert_allclose(pla.numpy(), np.asarray(la), atol=1e-6)
    e = eng.local_energy_proxy(words, pla, pph,
                               torch.ones(words.shape[0], dtype=torch.bool))
    for field in ("e_re", "e_im"):
        np.testing.assert_allclose(getattr(e, field).numpy(),
                                   np.asarray(getattr(je, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    assert int(e.found_pairs) == int(je.found_pairs)

    dets = np.asarray(sw)[:, 0].astype(np.int64)
    psi = np.exp(pla.double().numpy() + 1j * pph.double().numpy())
    dense = _dm_dense(6)[np.ix_(dets, dets)]
    exact = dense @ psi / psi
    np.testing.assert_allclose(e.e_re.numpy(), exact.real, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(e.e_im.numpy(), exact.imag, rtol=2e-4,
                               atol=2e-4)


def test_real_hamiltonian_has_no_group_phase():
    assert PauliEngine(ss.tfi_hamiltonian(6), device="cpu").group_phase \
        is None
    zero = ss.tfi_hamiltonian(6)
    zero.phase_offsets = np.zeros(zero.n_groups)
    assert PauliEngine(zero, device="cpu").group_phase is None


@pytest.mark.parametrize("membership", ["prefilter", "auto"])
def test_prefilter_refuses_phase_channel(membership):
    ham = ss.dm_chain_hamiltonian(24)
    with pytest.raises(ValueError, match="phase channel"):
        PauliEngine(ham, device="cpu", membership=membership)
    PauliEngine(ham, device="cpu", membership="hash")
    PauliEngine(ss.tfi_hamiltonian(24), device="cpu", membership=membership)


def test_exact_sampling_needs_a_molecule():
    ham = ss.tfi_hamiltonian(4)
    masker = Masker([idle_symmetry(4)])
    with pytest.raises(ValueError, match="exact"):
        VMC(ham=ham, masker=masker, config=VMCConfig(sampling_mode="exact"),
            device="cpu")
    with pytest.raises(ValueError, match="qubit_perm"):
        VMC(ham=ham, masker=masker,
            config=VMCConfig(qubit_perm=(1, 0, 2, 3)), device="cpu")
    with pytest.raises(ValueError):
        VMC(ham=ham, device="cpu")


def test_run_without_molecule(tmp_path):
    """``run()`` on an explicit Hamiltonian: ``result.csv`` under the
    header JAX's ``run`` writes for the same chain; the full energy (every
    partner through the net, the phase channel in ``local_energy_full``)
    equal to the sampled energy, since 64 samples cover DM-6's whole basis;
    checkpoints, and a resume from ``ckpt_2`` that repeats rows 2-3."""
    cfg = dict(sample_num=64, sampling_mode="gumbel", qubit_per_qudit=2,
               lr=1e-2, seed=0, symmetry_level="no_sym", iter_num=4,
               full_energy_period=2)
    acfg = dict(hidden_widths=(16,), aux_hidden_widths=(16,))
    jv = jvmc.VMC(config=jvmc.VMCConfig(**cfg),
                  anqs_config=JaxAnqsConfig(**acfg), ham=_jax_dm_chain(6),
                  masker=JaxMasker([jax_idle_symmetry(6)]), ref_det=0,
                  run_dir=str(tmp_path / "jax"))
    jv.run(iter_num=2, checkpoint_every=None)

    def port_vmc():
        return VMC(config=VMCConfig(**cfg), anqs_config=AnqsConfig(**acfg),
                   ham=ss.dm_chain_hamiltonian(6),
                   masker=Masker([idle_symmetry(6)]), ref_det=0,
                   device="cpu", run_dir=str(tmp_path / "port"))

    _, history, _ = port_vmc().run(checkpoint_every=2)
    with open(tmp_path / "jax" / "result.csv") as f:
        want = f.readline().strip()
    with open(tmp_path / "port" / "result.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == want and len(lines) == 5
    row = history[2]
    assert abs(row["full_energy"] - row["energy"]) < 1e-5
    _, again, _ = port_vmc().run(
        resume_from=str(tmp_path / "port" / "ckpt_2"), checkpoint_every=None)
    assert [r["iter_idx"] for r in again] == [2, 3]
    for a, b in zip(again, history[2:]):
        assert abs(a["energy"] - b["energy"]) < 1e-6


# The training configurations of chip_smoke.py's spin phase (JAX
# tests/test_spin_systems.py:191-215, tests/test_oracles.py:199-261).
STEP_CASES = {
    "dm6": (lambda m: _jax_dm_chain(6), lambda m: ss.dm_chain_hamiltonian(6),
            lambda s: s(6), 0, 64),
    "xxz8": (lambda m: m.heisenberg_xxz_hamiltonian(8),
             lambda m: m.heisenberg_xxz_hamiltonian(8),
             None, sum(1 << i for i in range(0, 8, 2)), 128),
    "tfi10": (lambda m: m.tfi_hamiltonian(10), lambda m: m.tfi_hamiltonian(10),
              lambda s: s(10), 0, 1024),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_one_step_matches_jax(name):
    jax_build, port_build, idle, ref_det, sample_num = STEP_CASES[name]
    if idle is None:
        jmasker = JaxMasker([jax_particle_number_symmetry(8, 4)])
        masker = Masker([particle_number_symmetry(8, 4)])
    else:
        jmasker = JaxMasker([idle(jax_idle_symmetry)])
        masker = Masker([idle(idle_symmetry)])
    cfg = dict(sample_num=sample_num, sampling_mode="gumbel",
               qubit_per_qudit=2, seed=0, symmetry_level="no_sym")
    _, v, jm, metrics, grads, want = step_pair_explicit(
        dict(ham=jax_build(jss), masker=jmasker, ref_det=ref_det),
        dict(ham=port_build(ss), masker=masker, ref_det=ref_det),
        cfg, dict(hidden_widths=(64,)))
    assert v.sector_words is None and v.engine.membership == "table"
    assert_step_matches(jm, metrics, grads, want,
                        names=("energy", "energy_imag"))
    # energy_var to 1e-6 relative: XXZ-8's initial variance is ~20 Ha^2,
    # where one float32 ulp is 1.9e-6.
    var, jvar = float(metrics["energy_var"]), float(jm["energy_var"])
    assert abs(var - jvar) <= 1e-6 * max(1.0, abs(jvar))
