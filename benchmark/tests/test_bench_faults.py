"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath: ``correct`` has to come out false for each fault a
training cell can have -- a step that leaves the state unchanged, half of
the batch left out (the estimates over the rest), a local energy altered
where it is produced, and the exchange between ranks left out."""

import json

import pytest
import torch

import run
from benchlib import launch

ARGS = ["--seed", "2147483659", "--seconds", "0.5", "--trace", "0"]


def _result(capsys, tiny, cell):
    assert run.main(["--workload", cell, *ARGS], device="cpu",
                    manifest=tiny) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(capsys, tiny):
    assert _result(capsys, tiny, "tiny.sampled")["correct"] is True


def test_state_left_unchanged(capsys, tiny, monkeypatch):
    from anqs_quantum_chemistry_torch.experiments import vmc

    monkeypatch.setattr(vmc.FiniteGuardOptimizer, "step",
                        lambda self, grads, cfg: True)
    res = _result(capsys, tiny, "tiny.sampled")
    assert res["correct"] is False
    assert res["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(capsys, tiny, monkeypatch):
    from anqs_quantum_chemistry_torch.experiments import vmc

    support = vmc.VMC._support

    def half(self, *args, **kwargs):
        words, weights, valid, stats = support(self, *args, **kwargs)
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return words, weights, valid, stats

    monkeypatch.setattr(vmc.VMC, "_support", half)
    assert _result(capsys, tiny, "tiny.sampled")["correct"] is False


def test_a_local_energy_altered(capsys, tiny, monkeypatch):
    from anqs_quantum_chemistry_torch.observables import pauli

    combine = pauli.PauliEngine._combine_via_t

    def altered(self, me, la_p, ph_p, found, log_abs, phase, valid):
        e = combine(self, me, la_p, ph_p, found, log_abs, phase, valid)
        top = int(torch.argmax(torch.where(valid, log_abs, -torch.inf)))
        shift = torch.zeros_like(e.e_re)
        shift[top] = 1.0
        return e._replace(e_re=e.e_re + shift,
                          t_re=e.t_re + shift * torch.exp(log_abs))

    monkeypatch.setattr(pauli.PauliEngine, "_combine_via_t", altered)
    assert _result(capsys, tiny, "tiny.sampled")["correct"] is False


def test_exchange_between_ranks_left_out(capsys, tiny, monkeypatch):
    import fault_ranks

    assert _result(capsys, tiny, "tiny.dp2")["correct"] is True
    monkeypatch.setattr(launch, "run_rank", fault_ranks.exchange_left_out)
    assert _result(capsys, tiny, "tiny.dp2")["correct"] is False
