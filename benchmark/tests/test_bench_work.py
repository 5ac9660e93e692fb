"""The benchmark's own counts: a step's flops by hand at N2's widths and
against what the program executes, kernel #1's bytes from its signature,
and shares that cannot pass 100%."""

import pytest
import torch

from benchlib import inputs, program, work
from benchlib.manifest import ansatz_of

N2 = {"ansatz": {"net_type": "made", "head_mode": "log_abs_phase",
                 "hidden_widths": [512], "aux_hidden_widths": [512],
                 "logit_cap": None},
      "vmc": {"qubit_per_qudit": 10}}


def _n2_flops(rows, sampled, k=50):
    made = ansatz_of(N2)
    shape = made.shape(N2, {"qubit_num": 20})
    return work.step_flops(made.flops(shape, rows, sampled), rows, k)


def test_n2_flops_by_hand():
    """N2 sector at MADE-512: 20 qubits, 2 qudits of 10, D 1024."""
    made = ansatz_of(N2)
    assert made.shape(N2, {"qubit_num": 20}) == {
        "n": 20, "q": 2, "d": 1024, "hidden": 512, "aux_hidden": 512,
        "widths": [10, 10]}
    f_main = 2 * (20 * 512 + 512 * 2048)
    f = 2 * f_main
    b = 2 * (f_main + 2 * 512 * 2048)
    p = 2 * (20 * 512 + 512 + 512 * 2048 + 2048)
    k, rows = 50, 14464
    sampler = (1 + 1024) * f_main
    minsr = (k * (f + b) + 8 * k * k * p + 8 * k * p
             + 2 * (2 * k) ** 3 // 3 + 2 * (2 * k) ** 2)
    want = sampler + rows * f + rows * (f + b) + f + minsr
    assert _n2_flops(rows, True, k) == want
    assert work.frontier_rows([10, 10], 14464) == [1, 1024]
    assert work.frontier_rows([6] * 4, 1024) == [1, 64, 1024, 1024]
    # Exact summation draws nothing.
    assert _n2_flops(rows, True, k) - _n2_flops(rows, False, k) == sampler
    # About 294 GFLOP a step: 335.3 counted less jacrev's redundant work.
    assert 2.9e11 < want < 3.0e11


def test_flops_against_the_programs_count(tiny):
    """Equal to the program's matmul-class flops of one step
    (``step_cost_analysis``) with MinSR's Jacobians in the per-row form,
    and never above what the program executes."""
    from anqs_quantum_chemistry_torch.utils import cost

    cell = tiny.cell("tiny.sampled")
    config = tiny.config(cell["config"])
    vmc, _, _ = program.build(config, cell, 5, torch.device("cpu"))
    by_source = vmc.step_cost_analysis()["by_source"]
    made = ansatz_of(config)
    shape = made.shape(config, inputs.molecule_sizes(config))
    k = config["sr"]["max_indices_num"]
    rows = cell["vmc"]["sample_num"]
    out = shape["q"] * shape["d"]
    dims = [(shape["n"], shape["hidden"]), (shape["hidden"], out),
            (shape["n"], shape["aux_hidden"]), (shape["aux_hidden"], out)]
    f = sum(2 * a * c for a, c in dims)
    b = f + sum(2 * a * c for a, c in (dims[1], dims[3]))
    per_row = k * (f + b)
    executed = cost.matmul_flops(by_source)
    jacobians = cost.matmul_flops(by_source, "minsr_jacobians")
    ours = work.step_flops(made.flops(shape, rows, True), rows, k)
    assert ours == executed - jacobians + per_row
    assert ours <= executed


def test_kernel1_bytes_from_its_signature():
    peak = {"hbm_bytes_per_s": 3.35e12, "float32_flops_per_s": 67e12}
    b, w, t, m = 14464, 1, 2958, 536
    want = 4 * b * w + t * (4 * w + 4) + 4 * (m + 1) + 4 * b * m
    least, bound = work.me_least_seconds(b, w, t, m, peak)
    assert bound == "bytes"
    assert least == pytest.approx(want / 3.35e12)
    assert 9.2e-6 < least < 9.4e-6
    # Few groups and many terms: the operations bound it.
    least, bound = work.me_least_seconds(4096, 1, 1 << 20, 1, peak)
    assert bound == "flops"
    assert least == pytest.approx(2 * 4096 * (1 << 20) / 67e12)


class _Trace:
    def __init__(self, kernel_s, window_s, busy_s):
        self.window_s, self.busy_s = window_s, busy_s
        self.device = [("fused_me_kernel<1>", 0.0, kernel_s * 1e6)]
        self._k = kernel_s

    def kernel_times(self, part):
        return [self._k] if part in "fused_me_kernel<1>" else []


def test_shares_never_pass_100(tiny):
    """At the least time a step or kernel #1 could take the shares read
    100%, and any longer time less."""
    readers = tiny.readers("tiny.sector")
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    flops = _n2_flops(14464, True)
    k1 = {"rows": 14464, "n_words": 1, "n_terms": 2958, "n_groups": 536}
    least, _ = work.me_least_seconds(14464, 1, 2958, 536, peak)
    for stretch in (1.0, 1.7, 25.0):
        ctx = {"trace": _Trace(least * stretch, 1.0, 0.9), "busy_s": 0.9,
               "stages": None, "chips": 1, "peak": peak, "flops": flops,
               "step_s": stretch * flops / peak["float32_flops_per_s"],
               "kernel1": k1}
        mfu = readers["step_mfu_pct"][0](ctx)
        roof = readers["me_roofline_pct"][0](ctx)
        assert mfu == pytest.approx(100.0 / stretch)
        assert roof == pytest.approx(100.0 / stretch)
        assert mfu <= 100.0 + 1e-9 and roof <= 100.0 + 1e-9
        assert 0.0 <= readers["device_idle_pct"][0](ctx) <= 100.0
