"""The transformer in the benchmark on the CPU, at a test-only C2H4/6-31G
configuration (``tiny/configs/c2h4_tiny_transformer.json``: the cell's
molecule, qudits, pinned set and prefilter at a d_model 16 decoder, with
``transformer_init``'s seeded weights): the ansatz file's ``check`` and
``param_shapes`` against the port's state dict, its flops by hand, the
plain reference's log psi and local energies against the program's, one
followed step, a traced run that reads ``tx_sample_positions_x``, and a
planted fault -- the causal mask left out of the program's decoders --
that fails ``log_psi_gap``."""

import json
import os

import numpy as np
import pytest
import torch

import run
from benchlib import inputs, judge, program, work
from benchlib.manifest import Manifest, ansatz_of
from conftest import REPO_DIR, TINY_DIR
from reference.ansatz import words_to_bits
from reference.hamiltonian import GroupedPauliHamiltonian

CPU = torch.device("cpu")
CELL = "tiny.tx"
SEED = 3000000019
CONFIG = os.path.join(TINY_DIR, "configs", "c2h4_tiny_transformer.json")
FULL = os.path.join(REPO_DIR, "benchmark", "configs",
                    "c2h4_631g_transformer128.json")
STAGES = {"sample_ms", "log_psi_ms", "local_energy_ms", "grad_ms", "sr_ms"}


def _full():
    with open(FULL) as f:
        return json.load(f)


def _port_anqs(config, seed=3):
    """The port's ANQS of ``config`` with ``transformer_init``'s weights
    from a generator seeded ``seed``."""
    from anqs_quantum_chemistry_torch.chem.molecule import Molecule
    from anqs_quantum_chemistry_torch.experiments.preparation import (
        create_masker,
    )
    from anqs_quantum_chemistry_torch.models.anqs import ANQS, AnqsConfig
    from anqs_quantum_chemistry_torch.symmetries import QubitGrouping

    mol = Molecule.from_npz(inputs.molecule_path(config))
    grouping = QubitGrouping.create(create_masker(mol, "e_num_spin"),
                                    config["vmc"]["qubit_per_qudit"])
    return ANQS(grouping, AnqsConfig(**config["ansatz"]),
                generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def tiny_tx(tmp_path_factory):
    """(manifest, cell, configuration) of the tiny cell: the weights
    written where the configuration's ``init`` names them, every per-layer
    metric of the repository's manifest on the cell."""
    tmp = tmp_path_factory.mktemp("tiny_tx")
    with open(CONFIG) as f:
        config = json.load(f)
    state = _port_anqs(config).state_dict()
    config["init"]["weights"] = str(tmp / "init.npz")
    np.savez(config["init"]["weights"],
             **{k: v.numpy() for k, v in state.items()})
    (tmp / "config.json").write_text(json.dumps(config))
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        ours = json.load(f)
    data = {**ours, "configs": [{
        "name": "c2h4_tiny_tx", "source": "test only",
        "file": str(tmp / "config.json"), "reduced": config["reduced"],
        "why": "CPU rehearsal"}],
        "workloads": [{"name": CELL, "config": "c2h4_tiny_tx",
                       "traffic": CELL, "chips": 1, "why": "CPU rehearsal"}],
        "per_layer": [{**m, "workloads": [CELL]} for m in ours["per_layer"]]}
    (tmp / "BENCHMARK.json").write_text(json.dumps(data))
    man = Manifest(str(tmp / "BENCHMARK.json"),
                   os.path.join(TINY_DIR, "workloads"))
    cell = man.cell(CELL)
    return man, cell, man.config(cell["config"])


@pytest.fixture(scope="module")
def first(tiny_tx):
    """The program's first window on the tiny cell: its initial weights,
    the followed steps' sets and rows, energies, first gradient and the
    parameters after them."""
    _, cell, config = tiny_tx
    vmc, state, params0 = program.build(config, cell, 13, CPU)
    steps = program.FirstSteps(vmc, state, judge.FOLLOWED_STEPS)
    _, warm = vmc._multi_step(judge.FOLLOWED_STEPS)(state)
    steps.close()
    assert program.step_failures(warm) == 0
    return {"params0": params0,
            "sets": [s[0][s[1]] for s in steps.sets],
            "rows": [tuple(t[s[1]] for t in s[2:]) for s in steps.sets],
            "energies": [float(e) for e in warm["energy"]],
            "grad1": steps.grad1, "params_n": steps.params_n}


def test_check_covers_exactly_the_transformer_keys():
    config = _full()
    ansatz_of(config)
    for change in ({"head_mode": "log_psi"}, {"hidden_widths": [128]},
                   {"n_heads": 6}):
        bad = {**config, "ansatz": {**config["ansatz"], **change}}
        with pytest.raises(ValueError):
            ansatz_of(bad)
    del config["ansatz"]["d_ff"]
    with pytest.raises(ValueError):
        ansatz_of(config)


@pytest.mark.parametrize("path", [CONFIG, FULL])
def test_param_shapes_are_the_ports_state_dict(path):
    """Names, shapes and order: the port's state dict at the tiny size and
    at the cell's, whose packaged warm state holds exactly these 82
    leaves."""
    with open(path) as f:
        config = json.load(f)
    net = ansatz_of(config)
    shapes = net.param_shapes(net.shape(config,
                                        inputs.molecule_sizes(config)))
    state = _port_anqs(config).state_dict()
    assert [(k, tuple(v.shape)) for k, v in state.items()] == [
        (k, tuple(s)) for k, s in shapes.items()]
    if path == FULL:
        with np.load(os.path.join(REPO_DIR, config["init"]["weights"])) as f:
            assert {k: f[k].shape for k in f.files} == shapes
        assert len(shapes) == 82


def test_flops_by_hand():
    """The tiny decoders: 52 qubits in 13 qudits of 4 (D 16), d_model 16,
    2 layers, d_ff 32; 128 Gumbel rows."""
    with open(CONFIG) as f:
        config = json.load(f)
    net = ansatz_of(config)
    s = net.shape(config, {"qubit_num": 52})
    assert s == {"n": 52, "q": 13, "d": 16, "d_model": 16, "n_layers": 2,
                 "n_heads": 4, "d_ff": 32, "widths": [4] * 13}
    proj = 4 * 2 * 16 * 16  # q, k, v, o at one position
    ff = 2 * 2 * 16 * 32
    head = 2 * 16 * 16

    def attn(keys):  # scores and weighted sum
        return 2 * 2 * 16 * keys

    one_net = sum(2 * (proj + ff + attn(q + 1)) + head for q in range(13))
    f = net.flops(s, 128, True)
    assert f["forward"] == 2 * one_net
    assert f["backward"] == 4 * one_net
    rows = [1, 16, 128] + [128] * 10
    assert work.frontier_rows(s["widths"], 128) == rows
    assert f["sampler"] == sum(r * (2 * (proj + ff + attn(q + 1)) + head)
                               for q, r in enumerate(rows))
    assert net.flops(s, 128, False)["sampler"] == 0
    block = 4 * 16 * 16 + 4 * 16 + 2 * 16 * 32 + 32 + 16
    assert f["params"] == 2 * (13 * 16 * 16 + 13 * 16 + 16 + 16 * 16 + 16
                               + 2 * block)


def test_full_cell_counts():
    """The cell's step (6144 rows, MinSR top 50): ~0.84 TFLOP, of which the
    cached draw over 41,233 frontier rows is ~0.049; 1,247,520
    parameters."""
    config = _full()
    net = ansatz_of(config)
    s = net.shape(config, inputs.molecule_sizes(config))
    f = net.flops(s, 4096, True)
    assert sum(work.frontier_rows(s["widths"], 4096)) == 41233
    assert f["params"] == 1247520
    assert 3.0e7 < f["forward"] < 3.2e7
    assert 4.8e10 < f["sampler"] < 5.0e10
    assert 0.83e12 < work.step_flops(f, 6144, 50) < 0.85e12


def test_flops_never_above_what_the_program_executes(tiny_tx):
    """The program's sampler recomputes every position at every qudit and
    its attention fills the whole causal square: it executes more matmul
    flops than the method's count."""
    from anqs_quantum_chemistry_torch.utils import cost

    _, cell, config = tiny_tx
    vmc, _, _ = program.build(config, cell, 5, CPU)
    executed = cost.matmul_flops(vmc.step_cost_analysis()["by_source"])
    net = ansatz_of(config)
    rows = cell["vmc"]["sample_num"] + config["vmc"]["couple_ref_dets"]
    ours = work.step_flops(net.flops(net.shape(
        config, inputs.molecule_sizes(config)), 128, True), rows,
        config["sr"]["max_indices_num"])
    assert 0 < ours <= executed


def test_log_psi_matches_the_port(tiny_tx, first):
    _, _, config = tiny_tx
    net = ansatz_of(config).reference(config, inputs.molecule_sizes(config),
                                      CPU)
    words = first["sets"][0]
    la_p, ph_p = first["rows"][0][:2]
    with torch.no_grad():
        la_r, ph_r = net.log_psi(first["params0"],
                                 words_to_bits(words, net.n))
    assert words.shape == (128 + 64, 2)
    torch.testing.assert_close(la_r, la_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ph_r, ph_p, rtol=1e-5, atol=1e-5)


def test_local_energies_match_the_port(tiny_tx, first):
    _, _, config = tiny_tx
    ham = GroupedPauliHamiltonian(inputs.molecule_path(config))
    for words, (la, ph, t_re, t_im) in zip(first["sets"], first["rows"]):
        r_re, r_im = ham.local_energy_numerators(words, la, ph)
        scale = float(r_re.abs().max())
        torch.testing.assert_close(t_re.double(), r_re, rtol=0,
                                   atol=1e-5 * scale)
        torch.testing.assert_close(t_im.double(), r_im, rtol=0,
                                   atol=1e-5 * scale)


def test_one_followed_step_matches_the_program(tiny_tx, first):
    _, cell, config = tiny_tx
    values, ref = judge.readings(config, cell, first["params0"],
                                 first["sets"], first["energies"],
                                 first["grad1"], first["params_n"],
                                 first["rows"], CPU)
    assert values["set_errors"] == 0
    assert abs(ref["energies"][0] - first["energies"][0]) < 1e-4
    assert values["energy_gap_ha"] < 1e-4
    assert values["grad_gap"] < 5e-4
    assert values["change_gap"] < 5e-2
    assert values["log_psi_gap"] < 1e-4
    assert values["local_energy_gap"] < 1e-5
    assert judge.verdict(values, cell["limits"])


def test_traced_run_reads_the_sampler_positions(capsys, tiny_tx):
    """``--trace 1``: correct, the stage times, and the draw's positions
    over a cached draw's -- 13, the full recompute of today's sampler."""
    man = tiny_tx[0]
    assert run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                     "0.5", "--trace", "1"], device="cpu", manifest=man) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["metrics"]["tx_sample_positions_x"] == {"value": 13.0,
                                                       "unit": "x"}
    assert STAGES <= set(res["metrics"])


def _reader():
    import importlib.util

    path = os.path.join(REPO_DIR, "benchmark", "metrics",
                        "tx_sample_positions_x.py")
    spec = importlib.util.spec_from_file_location("tx_reader", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader


def _read_as_the_session_does(reader, ctx):
    """``read(ctx)`` from a frame that holds the cell under the names
    ``benchlib/session.py``'s ``run`` gives it."""
    config = _full()
    net = ansatz_of(config)  # noqa: F841
    sizes = inputs.molecule_sizes(config)  # noqa: F841
    vmc_cfg = {**config["vmc"], "sample_num": 4096}  # noqa: F841
    return reader.read(ctx)


def test_reader_without_its_counter_or_cell_gives_none(monkeypatch):
    """Nothing counted (the parent program) or no caller holding the cell:
    no reading, nothing raised; else 41,233 positions a cached step."""
    from anqs_quantum_chemistry_torch.utils import spans

    reader = _reader()
    ctx = {"traced_steps": 5}
    monkeypatch.setattr(spans, "_profiled_counts", {})
    assert _read_as_the_session_does(reader, ctx) is None
    monkeypatch.setattr(spans, "_profiled_counts",
                        {"tx_sample_positions": 5 * 13 * 41233})
    assert reader.read(ctx) is None
    assert _read_as_the_session_does(reader, ctx) == pytest.approx(13.0)


def test_missing_causal_mask_fails_log_psi_gap(capsys, tiny_tx, monkeypatch):
    """The program's decoders attend to every position, later qudits too:
    ``correct`` false, by ``log_psi_gap``."""
    from anqs_quantum_chemistry_torch.models import transformer

    class NoCausalMask:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def tril(x, *args, **kwargs):
            return x

    monkeypatch.setattr(transformer, "torch", NoCausalMask())
    man, cell, _ = tiny_tx
    assert run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                     "0.5", "--trace", "0"], device="cpu", manifest=man) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    gap = res["compared"]["log_psi_gap"]
    assert res["correct"] is False
    assert gap["value"] > 100 * gap["limit"]


@pytest.mark.cuda
def test_tf32_reference_fails_where_the_program_passes(tiny_tx, card):
    """On the card: the tiny cell's program passes its limits, and the
    reference computed with TF32 matmuls, put in its place, fails one."""
    import control
    from anqs_quantum_chemistry_torch.ops import cuda_build

    cuda_build.build(["fused_me", "hash_lookup"])
    man, cell, config = tiny_tx
    got = control.program_first_steps(man, cell, config, SEED, card)
    parts = judge.reference_parts(config, card)
    sound, ref = judge.readings(config, cell, got["params0"], got["sets"],
                                got["energies"], got["grad1"],
                                got["params_n"], got["rows"], card,
                                parts=parts)
    low = control.follow(*parts[:2], got["params0"], got["sets"], parts[2],
                         tf32=True)
    tf32, _ = judge.readings(config, cell, got["params0"], got["sets"],
                             *control.as_program(low), card, parts=parts,
                             ref=ref)
    assert judge.verdict(sound, cell["limits"]), sound
    assert not judge.verdict(tf32, cell["limits"]), tf32
    assert torch.backends.cuda.matmul.allow_tf32 is False
