"""The VMC driver of the PyTorch port against the JAX package's: schedules,
the learning-rate schedule, checkpoints and resume, the best-model cascade,
``result.csv``, the full energy, the adaptive multinomial budget, step
windows, and exact summation (static membership, the full local energy, a
10-step trajectory from JAX's weights, and training to near E_FCI).

Small sizes throughout: H2, LiH and H2O/STO-3G from ``mols/``, MADE width 8
(32 where a test holds a trajectory against JAX's). Each tolerance is stated
where it is used."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.optim.sr import SRConfig as JaxSRConfig
from anqs_quantum_chemistry_tpu.utils import config as jconfig
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments.vmc import (
    VMC,
    FiniteGuardOptimizer,
    VMCConfig,
)
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.optim.sr import SRConfig
from anqs_quantum_chemistry_torch.utils.config import Schedule, schedule_lookup
from torch_port_common import molecules, to_np

H2_CFG = dict(sample_num=8, sampling_mode="gumbel", qubit_per_qudit=2,
              lr=5e-3, seed=1)


def make_vmc(tmp_path=None, width=8, **cfg):
    """The port's counterpart of ``tests/test_driver.py:make_vmc``: H2, 8
    Gumbel samples (the whole 4-determinant sector), MADE 8."""
    _, mol = molecules("H2")
    return VMC(mol, VMCConfig(**{**H2_CFG, **cfg}),
               AnqsConfig(hidden_widths=(width,), aux_hidden_widths=(width,)),
               device="cpu", run_dir=str(tmp_path) if tmp_path else None)


def flat_params(v):
    return torch.cat([p.detach().reshape(-1) for p in v.anqs.parameters()])


# ----------------------------------------------------------------------
# Schedules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_lookup_matches_jax(seed):
    """``Schedule.at`` and ``schedule_lookup`` equal JAX's at every
    iteration of random schedules (exact: the same binary search)."""
    rng = np.random.default_rng(seed)
    starts = [0] + sorted(rng.choice(np.arange(1, 200), 6,
                                     replace=False).tolist())
    entries = [(int(s), {"lr": float(rng.random())}) for s in starts]
    rng.shuffle(entries)
    port, ref = Schedule(entries), jconfig.Schedule(entries)
    assert port.starts == ref.starts and len(port) == len(ref)
    for it in range(0, 210):
        assert port.at(it) == ref.at(it)
        assert schedule_lookup(port, it) == jconfig.schedule_lookup(ref, it)
    assert schedule_lookup(0.5, 7) == jconfig.schedule_lookup(0.5, 7)
    assert port.to_dict() == ref.to_dict()
    for bad in ([], [(1, {})]):
        with pytest.raises(ValueError):
            Schedule(bad)


def test_schedules_resolve_and_run(tmp_path):
    """``tests/test_driver.py:test_schedules_resolve_and_run`` on the
    port: lr, sample_num, sr and grad_renorm change at their boundaries
    and the run crosses every one."""
    v = make_vmc(
        tmp_path, iter_num=9,
        opt_schedule=((0, {}), (3, {"lr": 1e-3})),
        sampling_schedule=((0, {}), (5, {"sample_num": 12})),
        proc_grad_schedule=(
            (0, {}),
            (7, {"sr": SRConfig(max_indices_num=4), "grad_renorm": True}),
        ),
    )
    assert v._schedule_overrides(0) == {}
    assert v._schedule_overrides(4) == {"lr": 1e-3}
    ov7 = v._schedule_overrides(7)
    assert ov7["sample_num"] == 12 and ov7["grad_renorm"] is True
    assert v._next_boundary(0) == 3
    assert v._next_boundary(3) == 5
    assert v._next_boundary(7) == float("inf")
    state, history, best = v.run(checkpoint_every=None)
    assert len(history) == 9
    assert state.opt.last_lr == pytest.approx(1e-3)
    np.testing.assert_allclose(history[8]["grad_norm"], 1.0, rtol=1e-5)
    assert np.isfinite(best["energy"])


def test_lr_schedule_matches_optax():
    """The rate of each applied update is optax's
    ``piecewise_constant_schedule`` at the count of applied updates
    (exactly, in float64), and a skipped non-finite step does not advance
    the count; the parameters follow ``apply_if_finite(adam(schedule))``
    to 1e-6."""
    sched = ((0, 1e-2), (2, 3e-3), (4, 1e-4))
    cfg = VMCConfig(lr_schedule=sched)
    entries = sorted(sched)
    lr = optax.piecewise_constant_schedule(
        init_value=entries[0][1],
        boundaries_and_scales={int(s): new / old for (_, old), (s, new)
                               in zip(entries[:-1], entries[1:])},
    )
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(5).astype(np.float32)
    nan = np.full(5, np.nan, np.float32)
    seq = [rng.standard_normal(5).astype(np.float32) for _ in range(6)]
    seq.insert(2, nan)  # skipped: the third update is applied at count 2
    opt = optax.apply_if_finite(optax.adam(lr), max_consecutive_errors=100)
    p, s = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    guard = FiniteGuardOptimizer([param], "adam")
    counts = []
    for g in seq:
        u, s = opt.update(jnp.asarray(g), s, p)
        p = optax.apply_updates(p, u)
        applied = guard.step([torch.from_numpy(g)], cfg)
        assert applied == bool(np.isfinite(g).all())
        if applied:
            counts.append(guard.count - 1)
            assert guard.last_lr == float(lr(guard.count - 1))
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(p),
                                   rtol=1e-6, atol=1e-7)
    assert counts == [0, 1, 2, 3, 4, 5]
    assert guard.total_notfinite == int(s.total_notfinite) == 1


def test_finite_guard_sgd_and_bad_type():
    """``opt_type='sgd'``: p <- p - lr g, as ``optax.sgd``; an unknown
    optimizer is refused."""
    param = torch.nn.Parameter(torch.ones(3))
    guard = FiniteGuardOptimizer([param], "sgd")
    guard.step([torch.full((3,), 2.0)], VMCConfig(lr=0.25))
    np.testing.assert_array_equal(param.detach().numpy(), [0.5] * 3)
    with pytest.raises(ValueError):
        FiniteGuardOptimizer([param], "rmsprop")


# ----------------------------------------------------------------------
# Weights, checkpoints, best model
# ----------------------------------------------------------------------
def test_init_weights_cache(tmp_path):
    cache = os.path.join(str(tmp_path), "weights")
    v1 = make_vmc(init_weights_cache=cache)
    v1.init_state()
    assert len(os.listdir(cache)) == 1
    v2 = make_vmc(init_weights_cache=cache)
    with torch.no_grad():  # a different init: the cache must replace it
        for prm in v2.anqs.parameters():
            prm.add_(1.0)
    v2.anqs.reset_parameters = lambda gen: None
    v2.init_state()
    assert torch.equal(flat_params(v1), flat_params(v2))
    make_vmc(init_weights_cache=cache, seed=2).init_state()
    assert len(os.listdir(cache)) == 2


def test_checkpoint_save_load_resume_roundtrip(tmp_path):
    """A resumed state continues bit for bit on the CPU: the same next
    step, and a run resumed from ``ckpt_2`` gives the uninterrupted run's
    rows 2-3 exactly."""
    v = make_vmc(tmp_path, iter_num=4)
    state = v.init_state()
    for _ in range(2):
        v.step(state)
    ckpt = os.path.join(str(tmp_path), "ckpt_test")
    v.save_checkpoint(ckpt, state, 2)
    v2 = make_vmc()
    state2, it2 = v2.load_checkpoint(ckpt)
    assert it2 == 2
    assert torch.equal(flat_params(v), flat_params(v2))
    assert v.step(state) == v2.step(state2)

    full_dir, resumed_dir = tmp_path / "full", tmp_path / "resumed"
    _, full, _ = make_vmc(full_dir).run(4, checkpoint_every=2)
    _, resumed, _ = make_vmc(resumed_dir).run(
        4, checkpoint_every=2, resume_from=str(full_dir / "ckpt_2"))
    assert [r["iter_idx"] for r in resumed] == [2, 3]
    for a, b in zip(full[2:], resumed):
        a.pop("wall_time")
        b.pop("wall_time")
        np.testing.assert_equal(a, b)  # NaN (no full energy) equals NaN


def test_checkpoint_mismatch_paths(tmp_path, caplog):
    """``tests/test_driver.py:119-184`` on the port: an optimizer-state
    mismatch starts a fresh optimizer with a logged warning and intact
    parameters; a parameter mismatch raises."""
    v = make_vmc(tmp_path)
    state = v.init_state()
    ckpt = os.path.join(str(tmp_path), "ckpt_m")
    v.save_checkpoint(ckpt, state, 7)

    v_sgd = make_vmc(opt_type="sgd")
    with caplog.at_level(logging.WARNING):
        state2, it2 = v_sgd.load_checkpoint(ckpt)
    assert it2 == 7
    assert torch.equal(flat_params(v), flat_params(v_sgd))
    assert state2.opt.opt_type == "sgd" and state2.opt.count == 0
    assert any("optimizer state structure" in r.getMessage()
               for r in caplog.records)

    with pytest.raises(ValueError, match="param tree does not match"):
        make_vmc(width=16).load_checkpoint(ckpt)


def test_best_model_cascade(tmp_path):
    extra = os.path.join(str(tmp_path), "series_scope")
    v = make_vmc(tmp_path, iter_num=3, save_best_model=True,
                 extra_best_dirs=(extra,))
    v.run(checkpoint_every=None)
    best_dir = os.path.join(str(tmp_path), "best_model")
    for d in (best_dir, extra):
        assert os.path.exists(os.path.join(d, "best_energy.npy"))
    e, it = np.load(os.path.join(best_dir, "best_energy.npy"))
    assert np.isfinite(e)
    top_e, top_it = np.load(os.path.join(str(tmp_path), "best_energy.npy"))
    assert top_e <= e and top_it >= it
    make_vmc().load_checkpoint(best_dir)


def test_init_params_and_profile_trace(tmp_path):
    """``run(init_params=...)`` starts from the given weights (H2's whole
    sector is sampled, so the first energy is theirs whatever the sampler
    noise), and ``profile_iters`` writes a ``torch.profiler`` trace to
    ``<run_dir>/profile``."""
    v_a = make_vmc()
    want = v_a.step(v_a.init_state())["energy"]
    v_a.init_state()
    weights = {k: t.clone() for k, t in v_a.anqs.state_dict().items()}
    v_b = make_vmc(tmp_path, seed=2)
    _, history, _ = v_b.run(3, checkpoint_every=None, init_params=weights,
                            profile_iters=(1, 1))
    assert history[0]["energy"] == want
    assert os.path.exists(tmp_path / "profile" / "trace.json")


# ----------------------------------------------------------------------
# result.csv, full energy, budget, windows
# ----------------------------------------------------------------------
def test_result_csv_header_matches_jax(tmp_path):
    """``result.csv``'s header is the one a JAX ``run(checkpoint_every=
    None)`` writes for the same config, and each value stands under its
    own column (also on a full-energy row, where JAX writes the four
    driver columns in another order than its header)."""
    cfg = dict(H2_CFG, iter_num=3, full_energy_period=2)
    jmol, _ = molecules("H2")
    jdir = tmp_path / "jax"
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(**cfg),
                  JaxAnqsConfig(hidden_widths=(8,), aux_hidden_widths=(8,)),
                  run_dir=str(jdir))
    jv.run(checkpoint_every=None)
    v = make_vmc(tmp_path / "port", iter_num=3, full_energy_period=2)
    _, history, _ = v.run(checkpoint_every=None)
    with open(jdir / "result.csv") as f:
        want = f.readline().strip()
    with open(tmp_path / "port" / "result.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == want
    assert len(lines) == 4
    for line, row in zip(lines[1:], history):
        values = dict(zip(lines[0].split(","), map(float, line.split(","))))
        assert values["iter_idx"] == row["iter_idx"]
        np.testing.assert_equal(values["full_energy"], row["full_energy"])
    assert np.isfinite(history[2]["full_energy"])


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_full_energy_on_fully_sampled_h2(tmp_path, steps_per_call):
    """The full energy lands on every ``full_energy_period``-th iteration,
    also in windows of ``steps_per_call``, and equals the energy where the
    whole sector is sampled (rtol 1e-5, as ``tests/test_driver.py:207``)."""
    v = make_vmc(tmp_path, iter_num=7, full_energy_period=3)
    _, history, _ = v.run(checkpoint_every=None,
                          steps_per_call=steps_per_call)
    measured = [i for i, h in enumerate(history)
                if np.isfinite(h["full_energy"])]
    assert measured == [3, 6]
    for i in measured:
        np.testing.assert_allclose(history[i]["full_energy"],
                                   history[i]["energy"], rtol=1e-5)


def test_sample_precisely_adapts_budget(tmp_path):
    """``tests/test_driver.py:269-296`` on the port: multinomial with
    ``sample_precisely``; the budget stays in [sample_num,
    max_multinomial_budget] and moves toward the unique-count target."""
    v = make_vmc(tmp_path, iter_num=6, sampling_mode="multinomial",
                 sample_num=4, sample_precisely=True, target_unique=3)
    budgets = []
    real_adapt = v._adapt_budget

    def spy(cfg, u):
        real_adapt(cfg, u)
        budgets.append(v._mult_budget)

    v._adapt_budget = spy
    _, history, _ = v.run(checkpoint_every=None)
    assert len(history) == 6
    assert all(4 <= b <= (1 << 27) for b in budgets)
    assert budgets[-1] <= 1 << 24
    for row in history:
        assert row["unique_num"] <= 4 and row["dropped"] >= 0
    # A unique count below the target grows the budget (at most 4x).
    v2 = make_vmc(sampling_mode="multinomial", sample_num=64,
                  sample_precisely=True, target_unique=32)
    v2._adapt_budget(v2.config, 4.0)
    assert v2._mult_budget == 256


def test_steps_per_call_gives_the_same_rows(tmp_path):
    """Windows of 3 steps run the same steps as single steps: the same
    rows, exactly (wall time aside)."""
    rows = []
    for spc in (1, 3):
        v = make_vmc(tmp_path / str(spc), iter_num=7, full_energy_period=4)
        rows.append(v.run(checkpoint_every=None, steps_per_call=spc)[1])
    for a, b in zip(*rows):
        a.pop("wall_time")
        b.pop("wall_time")
        np.testing.assert_equal(a, b)


# ----------------------------------------------------------------------
# Exact summation
# ----------------------------------------------------------------------
def _exact_pair(name, width=32, **cfg):
    """(JAX VMC, port VMC, JAX (params, opt_state, key), port state) in
    exact mode, the port at JAX's initial weights."""
    jmol, mol = molecules(name)
    kw = dict(sampling_mode="exact", qubit_per_qudit=6, lr=1e-3,
              grad_clip_norm=1.0, seed=3, **cfg)
    jv = jvmc.VMC(
        jmol, jvmc.VMCConfig(sr=JaxSRConfig(max_indices_num=50), **kw),
        JaxAnqsConfig(hidden_widths=(width,), aux_hidden_widths=(width,)),
    )
    v = VMC(mol, VMCConfig(sr=SRConfig(max_indices_num=50), **kw),
            AnqsConfig(hidden_widths=(width,), aux_hidden_widths=(width,)),
            device="cpu")
    jstate = jv.init_state()
    state = v.init_state()
    v.anqs.load_state_dict(params_from_jax(to_np(jstate[0])))
    return jv, v, jstate, state


@pytest.mark.parametrize("name", ["LiH", "H2O"])
@pytest.mark.parametrize("which", ["static", "full"])
def test_static_and_full_local_energies_match_jax(name, which):
    """``local_energy_static`` and ``local_energy_full`` over the whole
    sector at JAX's weights: e_re and e_im within 1e-6 of the batch's
    largest |e|; the full path alike at a chunk of 1000 partners."""
    jv, v, (params, _, _), _ = _exact_pair(name)
    words, valid = v.exact_words, v.exact_valid
    assert int(valid.sum()) == v.mol.fci_ndet
    assert np.array_equal(np.asarray(jv.exact_words).astype(np.int64),
                          words.numpy())
    jla, jph = jv.anqs.log_psi(params, jv.exact_words)
    la, ph = v.anqs.log_psi(words)
    with torch.no_grad():
        if which == "static":
            want = jv.engine.local_energy_static(
                jv.exact_words, jla, jph, jv.exact_valid,
                jv.exact_partner_idx, jv.exact_partner_found)
            got = [v.engine.local_energy_static(
                words, la, ph, valid, v.exact_partner_idx,
                v.exact_partner_found)]
        else:
            want = jv.engine.local_energy_full(
                jv.anqs, params, jv.exact_words, jla, jph, jv.exact_valid)
            got = [v.engine.local_energy_full(v.anqs, words, la, ph, valid,
                                              amp_chunk=chunk)
                   for chunk in (1 << 16, 1000)]
    scale = max(float(np.abs(np.asarray(want.e_re)).max()),
                float(np.abs(np.asarray(want.e_im)).max()))
    for e in got:
        assert int(e.found_pairs) == int(want.found_pairs)
        for a, b in ((e.e_re, want.e_re), (e.e_im, want.e_im)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6 * scale)


def test_exact_trajectory_matches_jax():
    """10 exact-summation steps on LiH from JAX's initial weights (MinSR
    top 50, clip 1.0, Adam 1e-3): no sampling noise, so every step's
    energy is within 1e-5 Ha of JAX's."""
    jv, v, (params, opt_state, key), state = _exact_pair("LiH")
    assert v.exact_partner_idx is not None
    want, got = [], []
    for _ in range(10):
        params, opt_state, key, jm = jv._step(params, opt_state, key)
        want.append(float(jm["energy"]))
        row = v.step(state)
        got.append(row["energy"])
        assert row["unique_num"] == 225 and row["dropped"] == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert want[-1] < want[0]


def test_exact_mode_matches_full_gumbel_and_trains():
    """``tests/test_driver.py:354`` on the port: the first exact step's
    energy equals a full-coverage Gumbel step's from the same weights
    (rtol 1e-6), and exact mode on H2 comes within 2.5e-3 Ha of E_FCI in
    800 steps at lr 1e-2."""
    _, mol = molecules("H2")
    anqs = AnqsConfig(hidden_widths=(8,), aux_hidden_widths=(8,))
    v_e = VMC(mol, VMCConfig(sampling_mode="exact", qubit_per_qudit=2,
                             lr=5e-3, seed=1), anqs, device="cpu")
    v_g = make_vmc()
    assert int(v_e.exact_valid.sum()) == 4
    assert v_e.exact_words.shape[0] == 64
    e_exact = v_e.step(v_e.init_state())["energy"]
    e_gumbel = v_g.step(v_g.init_state())["energy"]
    np.testing.assert_allclose(e_exact, e_gumbel, rtol=1e-6)

    v = VMC(mol, VMCConfig(sampling_mode="exact", qubit_per_qudit=2,
                           lr=1e-2, seed=1), anqs, device="cpu")
    _, _, best = v.run(800, checkpoint_every=None, steps_per_call=100)
    assert best["energy"] - mol.fci_energy < 2.5e-3


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------
def test_run_molecule_entry_point(tmp_path, capsys):
    """``experiments/run_molecule.py`` on a molecule file, on the CPU: it
    trains, writes its run directory and prints its verdict."""
    from anqs_quantum_chemistry_torch.experiments import run_molecule
    from torch_port_common import mol_path

    best = run_molecule.main(["run_molecule", mol_path("H2"), "3", "8"],
                             device="cpu", run_root=str(tmp_path))
    assert np.isfinite(best["energy"])
    run_dir = tmp_path / "h2_torch"
    assert {"result.csv", "config.json", "best_energy.npy"} <= set(
        os.listdir(run_dir))
    assert "gap to reference" in capsys.readouterr().out


def test_n2_convergence_entry_point(tmp_path, monkeypatch, capsys):
    """``experiments/n2_convergence.py`` for 3 steps on the CPU, at MADE
    width 8 (the card runs 512): the progress line and the verdict, and
    ``result.csv`` with 3 rows."""
    from anqs_quantum_chemistry_torch.experiments import n2_convergence

    real = n2_convergence.main_path_vmc
    monkeypatch.setattr(n2_convergence, "main_path_vmc",
                        lambda **kw: real(hidden_width=8, **kw))
    best, hit = n2_convergence.main(["n2_convergence", "3", str(tmp_path)],
                                    device="cpu")
    assert np.isfinite(best["energy"]) and hit is None
    out = capsys.readouterr().out
    assert "iter      0 E" in out and "chemical accuracy: None" in out
    with open(tmp_path / "result.csv") as f:
        assert len(f.read().splitlines()) == 4


def test_c2h4_transformer_entry_point(tmp_path, monkeypatch, capsys):
    """``experiments/c2h4_transformer.py`` for 2 steps on the CPU at the
    example's full transformer width, with 16 samples and 8 pinned HF
    neighbours (the card runs 4096 and 2048): prefilter membership, the
    progress line with ``pf_dropped_rows``, and ``result.csv`` under the
    JAX package's header with 2 rows."""
    from anqs_quantum_chemistry_torch.experiments import c2h4_transformer

    real = c2h4_transformer.c2h4_vmc
    monkeypatch.setattr(c2h4_transformer, "c2h4_vmc",
                        lambda **kw: real(couple_ref_dets=8, **kw))
    history, best = c2h4_transformer.main(
        ["c2h4_transformer", "2", "16"], device="cpu",
        run_root=str(tmp_path))
    assert np.isfinite(best["energy"]) and len(history) == 2
    for row in history:
        assert 16 <= row["unique_num"] <= 24
        assert row["found_pairs"] > row["unique_num"]  # pinned rows couple
        assert row["pf_dropped_rows"] == row["table_overflow"] == 0
    out = capsys.readouterr().out
    assert "membership prefilter" in out and "pf_dropped 0" in out
    with open(tmp_path / "c2h4_transformer_torch" / "result.csv") as f:
        lines = f.read().splitlines()
    assert len(lines) == 3 and lines[0].startswith("dropped,energy,")
    assert "pf_dropped_rows" in lines[0]
