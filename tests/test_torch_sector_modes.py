"""``VMCConfig.sector_membership`` ('auto', 'on', 'off') and its two limits
in the PyTorch port: the JAX package's ``tests/test_sector_membership.py``
case for case on the port (LiH, 128 Gumbel samples, qubit_per_qudit 3,
MADE 32, seed 3: 'on' against 'off' over a 6-step ``_multi_step`` window,
the same found pairs and energies within 1e-5, with and without the
spin-flip closure and the pinned HF neighbours; the 'auto' limits), one
step under 'on' against JAX's step under 'on' from the same weights and
uniforms, and the modes' edges: 'on' whatever the named membership, 'on'
refused where the ansatz leaves the sector or the sector is too large,
'off' always off."""

import numpy as np
import pytest

from anqs_quantum_chemistry_torch.chem.molecule import Molecule
from anqs_quantum_chemistry_torch.experiments import vmc as vmc_mod
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from torch_port_common import mol_path
from torch_step_common import assert_step_matches, step_pair

TRAJ = dict(sample_num=128, sampling_mode="gumbel", qubit_per_qudit=3,
            lr=1e-2, seed=3)


@pytest.fixture(scope="module")
def lih():
    return Molecule.from_npz(mol_path("LiH"), name="LiH")


def lih_vmc(mol, widths=(32,), **cfg):
    return VMC(mol, VMCConfig(**{**TRAJ, **cfg}),
               AnqsConfig(hidden_widths=widths), device="cpu")


def run_traj(mol, sector_membership, n_steps=6, **cfg_kw):
    vmc = lih_vmc(mol, sector_membership=sector_membership, **cfg_kw)
    if sector_membership == "on":
        assert vmc.sector_partner_idx is not None
    elif sector_membership == "off":
        assert vmc.sector_words is None
    _, m = vmc._multi_step(n_steps)(vmc.init_state())
    return m["energy"], m["found_pairs"]


@pytest.mark.parametrize("couplings", [
    {}, dict(couple_spin_flip=True, couple_ref_dets=8)],
    ids=["plain", "couplings"])
def test_sector_matches_table_membership(lih, couplings):
    """JAX's ``test_sector_matches_table_membership`` and
    ``test_sector_with_couplings``: the sector path and the dynamic table
    give the same pairs and energies within 1e-5 over six steps, also on
    the set the spin-flip closure and 8 pinned HF neighbours augment."""
    e_tab, f_tab = run_traj(lih, "off", **couplings)
    e_sec, f_sec = run_traj(lih, "on", **couplings)
    np.testing.assert_array_equal(f_tab, f_sec)
    np.testing.assert_allclose(e_sec, e_tab, rtol=1e-5, atol=1e-5)
    assert np.all(np.isfinite(e_sec)) and np.all(f_sec > 0)


def test_auto_thresholds(lih):
    """JAX's ``test_auto_thresholds``, and the entries limit: LiH's 225
    sector determinants fit the defaults; a dets limit of 64 or an entries
    limit one below 225 x M turns 'auto' off, as a named membership
    does."""
    on = lih_vmc(lih, (16,), sample_num=32)
    assert on.sector_words is not None
    n_entries = 225 * on.ham.n_groups
    for cfg in (dict(sector_membership_max_dets=64),
                dict(sector_membership_max_entries=n_entries - 1),
                dict(engine_overrides={"membership": "hash"}),
                dict(engine_overrides={"membership": "table"})):
        assert lih_vmc(lih, (16,), sample_num=32,
                       **cfg).sector_words is None, cfg
    assert lih_vmc(lih, (16,), sample_num=32,
                   sector_membership_max_entries=n_entries
                   ).sector_words is not None


def test_on_and_off_whatever_else_is_named(lih):
    """'on' (or True) builds the sector tables whatever ``membership`` and
    the limits say; 'off' (or False) never does; another value raises."""
    for cfg in (dict(sector_membership="on",
                     engine_overrides={"membership": "hash"}),
                dict(sector_membership=True, sector_membership_max_dets=1,
                     sector_membership_max_entries=1)):
        assert lih_vmc(lih, (16,), sample_num=32, **cfg).sector_words \
            is not None, cfg
    for mode in ("off", False):
        assert lih_vmc(lih, (16,), sample_num=32,
                       sector_membership=mode).sector_words is None
    with pytest.raises(ValueError, match="sector_membership"):
        lih_vmc(lih, (16,), sample_num=32, sector_membership="always")


def test_on_refuses_what_it_cannot_hold(lih, monkeypatch):
    """'on' raises where the ansatz samples outside the sector (masking
    depth 1: JAX keeps its sector path there and loses those samples'
    pairs, ROADMAP section 3) and above ``SECTOR_ON_MAX_DETS`` sector
    determinants (JAX asserts); 'auto' stays off at masking depth 1."""
    with pytest.raises(ValueError, match="outside the sector"):
        VMC(lih, VMCConfig(**TRAJ, sector_membership="on"),
            AnqsConfig(hidden_widths=(16,), masking_depth=1), device="cpu")
    assert VMC(lih, VMCConfig(**TRAJ), AnqsConfig(
        hidden_widths=(16,), masking_depth=1),
        device="cpu").sector_words is None
    monkeypatch.setattr(vmc_mod, "SECTOR_ON_MAX_DETS", 224)
    with pytest.raises(ValueError, match="too large"):
        lih_vmc(lih, (16,), sector_membership="on")


def test_sector_on_step_matches_jax():
    """One step under 'on' in both packages (LiH, 128 Gumbel samples,
    qubit_per_qudit 3, MADE 32, seed 3, JAX's weights and uniforms):
    gradients rtol 1e-4, energies 1e-6 Ha, the same pairs and set."""
    jv, v, jm, metrics, grads, want = step_pair(
        "LiH", dict(sample_num=128, sampling_mode="gumbel",
                    qubit_per_qudit=3, seed=3, sector_membership="on"),
        dict(hidden_widths=(32,)))
    assert jv.sector_partner_idx is not None
    assert v.sector_words is not None
    assert_step_matches(jm, metrics, grads, want)
