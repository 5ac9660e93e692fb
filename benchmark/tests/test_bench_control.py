"""The control on the card, at a size a test run holds: the reference
computed with TF32 matmuls, put in the program's place, has to fail a
number that the program passes. Full size: ``benchmark/control.py``."""

import pytest
import torch

import control
from benchlib import judge


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [41, 42, 43])
def test_tf32_reference_fails_where_the_program_passes(tiny, card, seed):
    from anqs_quantum_chemistry_torch.ops import cuda_build

    cuda_build.build(["fused_me", "hash_lookup"])
    cell = tiny.cell("tiny.sector")
    config = tiny.config(cell["config"])
    run = control.program_first_steps(tiny, cell, config, seed, card)
    parts = judge.reference_parts(config, card)
    sound, ref = judge.readings(config, cell, run["params0"], run["sets"],
                                run["energies"], run["grad1"],
                                run["params_n"], run["rows"], card,
                                parts=parts)
    low = control.follow(*parts[:2], run["params0"], run["sets"], parts[2],
                         tf32=True)
    tf32, _ = judge.readings(config, cell, run["params0"], run["sets"],
                             *control.as_program(low), card, parts=parts,
                             ref=ref)
    limits = cell["limits"]
    assert judge.verdict(sound, limits), sound
    assert not judge.verdict(tf32, limits), tf32
    assert torch.backends.cuda.matmul.allow_tf32 is False
