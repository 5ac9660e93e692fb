"""The VMC trainer of the PyTorch port against the JAX package, from the
same weights and sampler uniforms: on LiH (width 32, qubit_per_qudit 6, the
whole 225-determinant sector sampled, sector membership, MinSR top-50, clip
1.0), and on H2O/STO-3G through the dynamic-membership branch (the sample
set sorted, partners found by hash or table membership); and the overflow
policy of the dynamic branch."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.observables.pauli import (
    PauliEngine as JaxPauliEngine,
)
from anqs_quantum_chemistry_tpu.optim.sr import SRConfig as JaxSRConfig
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments.vmc import (
    VMC,
    FiniteGuardOptimizer,
    VMCConfig,
    it_targets,
)
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.optim.sr import SRConfig
from anqs_quantum_chemistry_torch.sampling.sampler import uniform_shapes
from torch_port_common import jax_uniforms, molecules, to_np

CFG = dict(sample_num=256, sampling_mode="gumbel", qubit_per_qudit=6,
           lr=1e-3, grad_clip_norm=1.0, seed=3)
# The JAX engine's (N, 2) amplitude table: the port's only layout.
JAX_ENGINE = dict(engine_overrides={"table_pairs_per_row": 1})


def build(temperature=1.0, name="LiH", port_cfg=None, **jax_overrides):
    jmol, mol = molecules(name)
    cfg = dict(CFG, grad_weight_temperature=temperature)
    jv = jvmc.VMC(
        jmol,
        jvmc.VMCConfig(sr=JaxSRConfig(max_indices_num=50),
                       **{**cfg, **JAX_ENGINE, **jax_overrides}),
        JaxAnqsConfig(hidden_widths=(32,)),
    )
    v = VMC(mol, VMCConfig(sr=SRConfig(max_indices_num=50),
                           **{**cfg, **(port_cfg or {})}),
            AnqsConfig(hidden_widths=(32,)), device="cpu")
    params, opt_state, key = jv.init_state()
    state = v.init_state()
    v.anqs.load_state_dict(params_from_jax(to_np(params)))
    return jv, v, (params, opt_state, key), state


def step_uniforms(v, key):
    """The uniforms of the JAX step at ``key`` (it splits off the sampler
    key first) and the key it hands to the next step."""
    key, sample_key = jax.random.split(key)
    return jax_uniforms(sample_key, uniform_shapes(v.anqs, CFG["sample_num"])
                        ), key


def _check_one_step(jv, v, p0, o0, key, state, unique_num, hf_rel=0.0):
    """One step of each package from the same weights and uniforms: the
    same gradients (SGD at lr 1 makes the JAX update minus the gradient
    itself) and metrics. ``hf_rel``: relative slack of the HF row's float32
    E_loc beyond 1e-6 Ha."""
    p1, _, _, jm = jv._step(p0, o0, key)
    want = params_from_jax(to_np(jax.tree.map(lambda a, b: a - b, p0, p1)))
    uniforms, _ = step_uniforms(v, key)
    metrics, grads = v._grads_and_metrics(state, uniforms)
    for name, g in grads.items():
        np.testing.assert_allclose(g.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert int(metrics["unique_num"]) == int(jm["unique_num"]) == unique_num
    assert int(metrics["found_pairs"]) == int(jm["found_pairs"])
    assert int(metrics["table_overflow"]) == int(jm["table_overflow"]) == 0
    for name in ("energy", "energy_var", "hf_proj_energy"):
        tol = 1e-6 + (hf_rel * abs(float(jm[name]))
                      if name == "hf_proj_energy" else 0.0)
        assert abs(float(metrics[name]) - float(jm[name])) < tol, name
    for name in ("grad_norm", "ipr", "max_log_abs", "min_log_abs"):
        assert float(metrics[name]) == pytest.approx(float(jm[name]),
                                                     rel=1e-5), name


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_one_step_grads_and_metrics(temperature):
    jv, v, (p0, o0, key), state = build(temperature, opt_type="sgd",
                                        lr=1.0)
    _check_one_step(jv, v, p0, o0, key, state, unique_num=225)


@pytest.mark.parametrize("membership", ["hash", "table"])
def test_dynamic_step_grads_and_metrics(membership):
    """H2O (441-determinant sector, 256 samples) with sector membership
    off: the JAX step and the port's, from the same weights and uniforms,
    through the sort and the engine's dynamic membership."""
    jv, v, (p0, o0, key), state = build(
        name="H2O", opt_type="sgd", lr=1.0, sector_membership="off",
        engine_overrides={"membership": membership,
                          "table_pairs_per_row": 1},
        port_cfg={"engine_overrides": {"membership": membership}},
    )
    assert v.sector_words is None and v.engine.membership == membership
    # The HF row's E_loc is one float32 sum at |E| ~ 75 Ha: 2 ulps.
    _check_one_step(jv, v, p0, o0, key, state, unique_num=256,
                    hf_rel=2.4e-7)


def _hash_pair(**kw):
    """(JAX VMC, port VMC) on H2O with hash membership; ``kw``: config
    fields of both."""
    jv, v, _, _ = build(
        name="H2O", **kw, engine_overrides={"membership": "hash"},
        port_cfg={"engine_overrides": {"membership": "hash"}, **kw},
    )
    return jv, v


def test_overflow_escalates_then_raises_at_cap():
    """A reported overflow doubles the bucket count (``hash_extra_bits``
    0 -> 1) and rebuilds the engine; at the escalation cap both packages
    raise (``max_overflow_escalations`` set to one escalation in both);
    with ``overflow_policy='raise'`` the first overflow raises, with
    'ignore' nothing changes."""
    jv, v = _hash_pair(max_overflow_escalations=1)
    row = {"table_overflow": 3.0, "pf_dropped_rows": 0.0}
    for drv in (jv, v):
        assert drv.engine.hash_extra_bits == 0
        drv._handle_overflow(dict(row))
        assert drv.engine.hash_extra_bits == 1
        assert drv.engine.membership == "hash"
        with pytest.raises(RuntimeError, match="overflow"):
            drv._handle_overflow(dict(row))
    # No overflow: nothing changes.
    v._handle_overflow({"table_overflow": 0.0})
    assert v.engine.hash_extra_bits == 1
    for policy in ("raise", "ignore"):
        jv, v = _hash_pair(overflow_policy=policy)
        for drv in (jv, v):
            if policy == "raise":
                with pytest.raises(RuntimeError, match="overflow"):
                    drv._handle_overflow(dict(row))
            else:
                drv._handle_overflow(dict(row))
            assert drv.engine.hash_extra_bits == 0


def test_run_acts_on_overflow(monkeypatch):
    """``run`` hands every step's ``table_overflow`` to the policy: with a
    bucket build that reports 5 dropped keys, the first step escalates and
    the second raises at a cap of one escalation."""
    _, v = _hash_pair(max_overflow_escalations=1)
    build_table = PauliEngine._hash_build

    def overflowing(self, *args):
        tab, nb, _ = build_table(self, *args)
        return tab, nb, torch.tensor(5, dtype=torch.int32)

    monkeypatch.setattr(PauliEngine, "_hash_build", overflowing)
    _, rows, _ = v.run(1, checkpoint_every=None)
    assert rows[0]["table_overflow"] == 5
    assert v.engine.hash_extra_bits == 1
    with pytest.raises(RuntimeError, match="overflow"):
        v.run(1, checkpoint_every=None)


def test_sector_limit_falls_back_to_dynamic():
    """Above the sector-membership limit (``sector_membership_max_dets``)
    the trainer takes the dynamic branch ('table' at LiH's 12 qubits) and
    trains the same step."""
    _, mol = molecules("LiH")
    kw = dict(CFG, sr=SRConfig(max_indices_num=50))
    rows = []
    for limit in (VMCConfig.sector_membership_max_dets, 224):  # LiH: 225
        v = VMC(mol, VMCConfig(**kw, sector_membership_max_dets=limit),
                AnqsConfig(hidden_widths=(8,)), device="cpu")
        assert (v.sector_words is None) == (limit == 224)
        rows.append(v.run(1, checkpoint_every=None)[1][0])
    assert rows[0]["found_pairs"] == rows[1]["found_pairs"]
    assert rows[0]["energy"] == pytest.approx(rows[1]["energy"], abs=1e-6)


def test_sector_membership_above_table_qubits(monkeypatch):
    """With ``MAX_TABLE_QUBITS`` below LiH's 12 qubits in both packages,
    both trainers keep sector membership (the engine's 'auto' resolving to
    'prefilter', which only ``local_energy_proxy`` uses) and build no
    direct-address ``sector_pos`` map: the sample set is sorted and
    searched in the sector. One step from the same weights and uniforms
    agrees as on the position-map path, and the engine's prefilter finds
    the sector path's pairs on the whole sector."""
    for engine in (JaxPauliEngine, PauliEngine):
        monkeypatch.setattr(engine, "MAX_TABLE_QUBITS", 10)
    jv, v, (p0, o0, key), state = build(opt_type="sgd", lr=1.0)
    assert jv.sector_words is not None and jv.sector_pos is None
    assert v.sector_words is not None and v.sector_pos is None
    assert jv.engine.membership == v.engine.membership == "prefilter"
    _check_one_step(jv, v, p0, o0, key, state, unique_num=225)
    words = v.sector_words
    valid = torch.arange(words.shape[0]) < v.mol.fci_ndet
    with torch.no_grad():
        la, ph = v.anqs.log_psi(words)
    ref = v.engine.local_energy_sector(
        words, la, ph, valid, v.sector_words, v.sector_partner_idx,
        v.sector_partner_found)
    e = v.engine.local_energy_proxy(words, la, ph, valid)
    assert int(e.found_pairs) == int(ref.found_pairs)
    assert int(e.pf_dropped_rows) == int(e.table_overflow) == 0
    for field in ("t_re", "t_im"):
        np.testing.assert_allclose(getattr(e, field).numpy(),
                                   getattr(ref, field).numpy(), rtol=4e-7,
                                   atol=1e-6, err_msg=field)


def test_three_step_energy_trajectory():
    jv, v, (params, opt_state, key), state = build()
    want, got = [], []
    for _ in range(3):
        uniforms, next_key = step_uniforms(v, key)
        params, opt_state, key, jm = jv._step(params, opt_state, key)
        assert np.array_equal(np.asarray(key), np.asarray(next_key))
        want.append(float(jm["energy"]))
        row = v.step(state, uniforms)
        got.append(row["energy"])
        assert row["unique_num"] == 225
        assert row["hf_log_abs"] == pytest.approx(float(jm["hf_log_abs"]),
                                                  abs=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert want[2] < want[0]  # the energy descends


def test_step_with_own_generator_is_seeded():
    _, v, _, _ = build()
    rows = []
    for _ in range(2):
        rows.append(v.run(2, checkpoint_every=None)[1])
        for row in rows[-1]:
            row.pop("wall_time")
    np.testing.assert_equal(rows[0], rows[1])
    assert all(np.isfinite(r["energy"]) for r in rows[0])


def test_finite_guard_matches_apply_if_finite():
    """Skip-non-finite Adam against optax.apply_if_finite(adam, 2): a NaN
    step is skipped, and the third NaN in a row is applied (the guard's
    learning rate is the step config's)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(5).astype(np.float32)
    steps = [rng.standard_normal(5).astype(np.float32) for _ in range(3)]
    nan = np.full(5, np.nan, np.float32)
    seq = [steps[0], nan, steps[1], steps[2], nan, nan, nan]

    opt = optax.apply_if_finite(optax.adam(1e-2), max_consecutive_errors=2)
    p, s = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    guard = FiniteGuardOptimizer([param], "adam", max_consecutive_errors=2)
    cfg = VMCConfig(lr=1e-2)
    for i, g in enumerate(seq):
        u, s = opt.update(jnp.asarray(g), s, p)
        p = optax.apply_updates(p, u)
        guard.step([torch.from_numpy(g)], cfg)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(p),
                                   rtol=1e-6, atol=1e-7, err_msg=str(i))
    assert guard.total_notfinite == int(s.total_notfinite) == 4


def test_it_targets_match_jax():
    rng = np.random.default_rng(2)
    n = 64
    la = (-3 + 0.5 * rng.standard_normal(n)).astype(np.float32)
    ph = rng.uniform(-3, 3, n).astype(np.float32)
    e_re = (-7.8 + rng.standard_normal(n)).astype(np.float32)
    e_im = (0.1 * rng.standard_normal(n)).astype(np.float32)
    valid = rng.random(n) < 0.9
    want = jvmc.it_targets(*map(jnp.asarray, (la, ph, e_re, e_im, valid)),
                           0.05)
    got = it_targets(*map(torch.from_numpy, (la, ph, e_re, e_im, valid)),
                     0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_unported_paths_raise():
    """Every membership of the JAX engine is ported: 'search' and
    'hash_dist' (one shard without a mesh) build. The NADE ansatz is
    ported (it builds); a net type of neither package raises
    ``ValueError``."""
    _, mol = molecules("LiH")
    anqs = AnqsConfig(hidden_widths=(8,))
    v = VMC(mol, VMCConfig(**CFG, engine_overrides={
        "membership": "hash_dist"}), anqs, device="cpu")
    assert v.engine.membership == "hash_dist" and v.engine.mesh is None
    VMC(mol, VMCConfig(**CFG, engine_overrides={"membership": "search"}),
        anqs, device="cpu")
    VMC(mol, VMCConfig(**CFG), AnqsConfig(net_type="nade"), device="cpu")
    with pytest.raises(ValueError, match="net_type"):
        VMC(mol, VMCConfig(**CFG), AnqsConfig(net_type="bf_state"),
            device="cpu")
    with pytest.raises(ValueError):  # no membership of either package
        VMC(mol, VMCConfig(**CFG, engine_overrides={
            "membership": "sector"}), anqs, device="cpu")
