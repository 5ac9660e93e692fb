"""Distillation-interleaved VMC, ``engine_overrides`` and the Li2O NADE
campaign's entry points in the PyTorch port, against the JAX package.

One cycle in exact summation (no sampling noise) from JAX's weights gives
JAX's ``_get_distill`` metrics and parameters; ``run`` places the cycles as
JAX's does (rows 3 and 6 of 7 at period 3, windows of 4) under JAX's
``result.csv`` header; ``engine_overrides`` reach the engine and refuse
what the port's engine lacks. The three entry points run at a small size
on the CPU.
"""

import csv

import jax
import numpy as np
import pytest

from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments.vmc import (
    VMC,
    VMCConfig,
    latest_checkpoint,
    li2o_nade_vmc,
)
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from torch_port_common import molecules, to_np

H2_CFG = dict(sample_num=8, sampling_mode="gumbel", qubit_per_qudit=2,
              lr=5e-3, seed=1)


def nets(net):
    kw = dict(hidden_widths=(16, 16), aux_hidden_widths=(16, 16),
              net_type="nade") if net == "nade" else dict(
        hidden_widths=(16,), aux_hidden_widths=(16,))
    return JaxAnqsConfig(**kw), AnqsConfig(**kw)


@pytest.mark.parametrize("name,qpq,net", [("H2", 2, "made"),
                                          ("LiH", 3, "nade")])
@pytest.mark.parametrize("loss", ["ce", "logmse"])
def test_cycle_matches_jax(name, qpq, net, loss):
    """One cycle in exact mode (40 steps, tau 0.1, lr 3e-3; 'logmse' at
    temperature 4) from JAX's initial weights: the three metrics and the
    returned parameters equal JAX's to 1e-5."""
    jmol, mol = molecules(name)
    kw = dict(sampling_mode="exact", qubit_per_qudit=qpq, seed=2,
              distill_period=10, distill_steps=40, distill_tau=0.1,
              distill_lr=3e-3, distill_loss=loss, distill_temperature=4.0)
    jcfg, cfg = nets(net)
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(**kw), jcfg)
    params, _, key = jv.init_state()
    dcall, dopt = jv._get_distill()
    jbest, _, _, jmet = dcall(params, dopt.init(params), key)

    v = VMC(mol, VMCConfig(**kw), cfg, device="cpu")
    state = v.init_state()
    v.anqs.load_state_dict(params_from_jax(to_np(params)))
    met = v.distill_cycle(state, v.make_distill_opt())
    for k in ("distill_loss_first", "distill_loss_last", "distill_energy"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(met["distill_loss_last"]) < float(met["distill_loss_first"])
    want = params_from_jax(to_np(jbest))
    live = live_outputs(v.anqs, v.exact_words[v.exact_valid])
    for k, p in v.anqs.state_dict().items():
        cols = live.get(k, slice(None))
        np.testing.assert_allclose(p.numpy()[..., cols],
                                   want[k].numpy()[..., cols], rtol=0,
                                   atol=1e-5, err_msg=k)
    la, ph = v.anqs.log_psi(v.exact_words)
    jla, jph = jv.anqs.log_psi(jbest, jv.exact_words)
    valid = v.exact_valid.numpy()
    np.testing.assert_allclose(la.detach().numpy()[valid],
                               np.asarray(jla)[valid], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ph.detach().numpy()[valid],
                               np.asarray(jph)[valid], rtol=0, atol=1e-5)


def live_outputs(anqs, words):
    """{output-layer parameter name: its columns of the continuations that
    the symmetry masks allow beside another on some prefix of ``words``}.
    A main-net column allowed on no such prefix has its conditional fixed
    at 1 (the only choice) or cancelled by the normalization, so its
    gradient is zero up to float32 rounding noise, which Adam scales to
    about the learning rate a step in either package: those columns
    compute nothing on ``words`` and are not compared."""
    masks = anqs.memo_path(words)[1] & anqs.pad_masks[None]
    choice = masks & (masks.sum(dim=-1, keepdim=True) > 1)
    allowed = choice.any(dim=0).numpy()
    last = len(anqs.main.spec.hidden_widths)
    if anqs.config.net_type == "nade":
        return {f"main.qudit{q}.{k}{last}": allowed[q]
                for q in range(anqs.qudit_num) for k in ("w", "b")}
    return {f"main.{k}{last}": allowed.reshape(-1) for k in ("w", "b")}


def test_run_interleaves_cycles_under_jax_header(tmp_path):
    """Cycles before iterations 3 and 6 of 7 (period 3, windows of 4 that
    stop at each cycle); their metrics on those rows only; ``result.csv``
    under the header JAX's ``run`` writes for a distilling config."""
    cfg = dict(H2_CFG, iter_num=7, distill_period=3, distill_steps=5,
               distill_tau=0.1)
    jmol, mol = molecules("H2")
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(**dict(cfg, iter_num=4)),
                  JaxAnqsConfig(hidden_widths=(8,), aux_hidden_widths=(8,)),
                  run_dir=str(tmp_path / "jax"))
    jv.run(checkpoint_every=None)
    v = VMC(mol, VMCConfig(**cfg),
            AnqsConfig(hidden_widths=(8,), aux_hidden_widths=(8,)),
            device="cpu", run_dir=str(tmp_path / "port"))
    cycles = []
    real = v.distill_cycle
    v.distill_cycle = lambda *a, **k: cycles.append(1) or real(*a, **k)
    steps = []
    real_step = v.step
    v.step = lambda *a, **k: steps.append(1) or real_step(*a, **k)
    _, history, best = v.run(checkpoint_every=None, steps_per_call=4)
    assert len(history) == 7 and len(cycles) == 2 and len(steps) == 7
    got = [i for i, h in enumerate(history)
           if np.isfinite(h["distill_loss_first"])]
    assert got == [3, 6]
    for i in got:
        assert np.isfinite(history[i]["distill_energy"])
        assert np.isfinite(history[i]["distill_loss_last"])
    assert np.isfinite(best["energy"])
    with open(tmp_path / "jax" / "result.csv") as f:
        want = next(csv.reader(f))
    with open(tmp_path / "port" / "result.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == want and want[-3:] == ["distill_loss_first",
                                              "distill_loss_last",
                                              "distill_energy"]
    assert len(rows) == 8
    assert float(rows[4][want.index("distill_loss_first")]) == (
        history[3]["distill_loss_first"])


def test_engine_overrides():
    """The overrides reach the engine (the Li2O campaign's prefilter
    capacities, and the escalation doubles them); a ``membership`` key
    turns sector membership off; ``weights_matmul``, ``me_chunk``,
    ``hash_epb`` and the 'hash_dist' routing slacks reach the engine; keys
    the port's engine lacks (``mesh`` is the trainer's own argument) and an
    unknown distillation loss raise."""
    vmc = li2o_nade_vmc(device="cpu", engine_overrides={
        "prefilter_row_capacity": 768, "prefilter_dense_rows": 4096,
        "pf_row_chunk": 512, "hash_extra_bits": 1})
    eng = vmc.engine
    assert eng.membership == "prefilter"
    assert (eng.prefilter_row_capacity, eng.prefilter_dense_rows,
            eng.pf_row_chunk, eng.hash_extra_bits) == (768, 4096, 512, 1)
    vmc._handle_overflow({"pf_dropped_rows": 3, "iter_idx": 0})
    assert (vmc.engine.prefilter_row_capacity,
            vmc.engine.prefilter_dense_rows,
            vmc.engine.hash_extra_bits) == (1536, 8192, 2)

    _, mol = molecules("H2")
    cfg = AnqsConfig(hidden_widths=(8,), aux_hidden_widths=(8,))
    assert VMC(mol, VMCConfig(**H2_CFG), cfg,
               device="cpu").sector_words is not None
    v = VMC(mol, VMCConfig(engine_overrides={"membership": "hash"},
                           **H2_CFG), cfg, device="cpu")
    assert v.sector_words is None and v.engine.membership == "hash"
    assert VMC(mol, VMCConfig(engine_overrides={
        "membership": "hash", "weights_matmul": "grouped"}, **H2_CFG),
        cfg, device="cpu").engine.weights_matmul == "grouped"
    eng = VMC(mol, VMCConfig(engine_overrides={
        "membership": "hash", "me_chunk": 64, "hash_epb": 16}, **H2_CFG),
        cfg, device="cpu").engine
    assert (eng.me_chunk, eng.hash_epb) == (64, 16)
    eng = VMC(mol, VMCConfig(engine_overrides={
        "membership": "hash_dist", "dist_entry_slack": 2.0,
        "dist_query_slack": 3.0}, **H2_CFG), cfg, device="cpu").engine
    assert (eng.dist_entry_slack, eng.dist_query_slack) == (2.0, 3.0)
    for bad in ({"lookup_kernel": "pallas"}, {"mesh": None}):
        with pytest.raises(ValueError, match=next(iter(bad))):
            VMC(mol, VMCConfig(engine_overrides=bad, **H2_CFG), cfg,
                device="cpu")
    with pytest.raises(ValueError, match="distill_loss"):
        VMC(mol, VMCConfig(distill_loss="mse", **H2_CFG), cfg, device="cpu")


def test_li2o_campaign_entry_points(tmp_path, capsys):
    """The three entry points at a small size on the CPU: CISD pretraining
    then VMC (N2, NADE (128, 128), 2 pretraining steps, 16 samples, 2
    iterations; a rerun resumes from ``ckpt_0``), the closure leg from the
    packaged JAX state and the distillation leg from the closure leg's run
    directory (16 samples each; a cycle at row 2 of 3)."""
    from anqs_quantum_chemistry_torch.experiments import (
        cisd_pretrain_vmc,
        li2o_closure,
        li2o_distill_closure,
    )

    argv = ["cisd_pretrain_vmc", "n2", "2", "16", "nade", "10", "1", "2"]
    history, best = cisd_pretrain_vmc.main(
        argv, device="cpu", run_root=str(tmp_path), stages=((2, 1e-3),))
    out = capsys.readouterr().out
    assert "CISD: 610 dets" in out and "pretrain     1" in out
    run_dir = tmp_path / "n2_cisd_nade_t2_torch"
    assert latest_checkpoint(str(run_dir)).endswith("ckpt_0")
    assert len(history) == 2 and np.isfinite(best["energy"])
    cisd_pretrain_vmc.main(argv, device="cpu", run_root=str(tmp_path))
    assert "resuming from" in capsys.readouterr().out
    # The transformer branch runs (it raised before ``matmul_precision``
    # was ported), from the CISD vector that the first run cached.
    history, _ = cisd_pretrain_vmc.main(
        argv[:4] + ["transformer", "10", "0", "1"], device="cpu",
        run_root=str(tmp_path), stages=((2, 1e-3),))
    out = capsys.readouterr().out
    assert "CISD solved" not in out and "CISD: 610 dets" in out
    assert len(history) == 2
    assert latest_checkpoint(str(tmp_path / "n2_cisd_transformer_emp_torch"))

    history, _ = li2o_closure.main(["li2o_closure", "", "2"], device="cpu",
                                   run_root=str(tmp_path), sample_num=16)
    out = capsys.readouterr().out
    assert "warm start from the packaged JAX closure state" in out
    assert len(history) == 2
    for row in history:
        assert row["unique_num"] == 16 and row["pf_dropped_rows"] == 0
        assert -88.75 < row["energy"] < -88.5  # near the JAX record

    closure_dir = str(tmp_path / "li2o_closure_torch")
    history, _ = li2o_distill_closure.main(
        ["li2o_distill_closure", closure_dir, "3"], device="cpu",
        run_root=str(tmp_path), sample_num=16, distill_period=2,
        distill_steps=3)
    assert f"warm start from {closure_dir}/ckpt_0" in capsys.readouterr().out
    assert [np.isfinite(h["distill_loss_first"]) for h in history] == [
        False, False, True]
