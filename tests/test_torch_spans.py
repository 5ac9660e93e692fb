"""The port's spans and counters (``utils/spans.py``) on the CPU: off, a
step touches no event, profiler range or clock; recorded, ``VMC.step``'s
stages partition the step, each span with its parent and step; the
prefilter's stages come once a row block and count their partners; kernel
#2's plain path counts its queries, and kernel #3's its launch and tier
in each stage 1; under ``torch.profiler`` the trace
holds the step's spans as ranges, and nothing else is recorded; and synchronizing calls are put down to
the innermost open span. The transformer's ``tx.forward`` counts its rows
and positions, a Gumbel draw its ``tx_sample_positions`` (one position a
row in its cached ``tx.decode`` steps), and spans that are off are one
shared null context. No JAX: the port's engine alone."""

import json
import os
import time
import warnings

import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_torch.chem.molecule import (
    MolConfig,
    Molecule,
    load_n2,
)
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops import bits as bitops
from anqs_quantum_chemistry_torch.ops import keys
from anqs_quantum_chemistry_torch.ops.hash_lookup import (
    ENTRIES,
    hash_lookup,
)
from anqs_quantum_chemistry_torch.optim.sr import SRConfig
from anqs_quantum_chemistry_torch.utils import spans

MOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mols")

# The partition of ``vmc.step`` on a sampled step with MinSR.
STAGES = {"vmc.support", "vmc.log_psi", "vmc.local_energy", "vmc.estimators",
          "vmc.grad", "vmc.sr", "vmc.update"}


@pytest.fixture(scope="module")
def n2():
    return load_n2()


def tiny_vmc(mol, **cfg):
    """N2 at MADE (16,), 64 Gumbel rows, sector membership, MinSR top 4."""
    cfg = {"sample_num": 64, "sampling_mode": "gumbel", "qubit_per_qudit": 2,
           "sr": SRConfig(max_indices_num=4), **cfg}
    return VMC(mol, VMCConfig(**cfg), AnqsConfig(hidden_widths=(16,),
                                                 aux_hidden_widths=(16,)),
               device="cpu")


def _refuse(*args, **kwargs):
    raise AssertionError("called with spans off")


def test_off_touches_no_event_range_or_clock(n2, monkeypatch):
    """With no recording and no profiler, a step creates no CUDA event,
    enters no ``record_function`` and reads no clock."""
    v = tiny_vmc(n2)
    state = v.init_state()
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(time, "perf_counter", _refuse)
    row = v.step(state)
    assert np.isfinite(row["energy"])


def test_recorded_window_is_the_span_tree(n2):
    """One ``_multi_step(2)``: two steps, each a ``vmc.step`` whose
    children are the stages, every span with its parent and its step, and
    self ms at most device ms."""
    v = tiny_vmc(n2)
    state = v.init_state()
    with spans.recording() as rec:
        v._multi_step(2)(state)
    assert rec.steps == 2 and not rec.cuda
    roots = [i for i, s in enumerate(rec.spans) if s.parent is None]
    assert [rec.spans[i].name for i in roots] == ["vmc.step"] * 2
    for step, root in enumerate(roots):
        mine = [s for s in rec.spans if s.step == step]
        below = {s.name for s in mine if s.parent == root}
        assert below == STAGES
        parent_of = {s.name: rec.spans[s.parent].name for s in mine
                     if s.parent is not None}
        assert parent_of["vmc.sample"] == "vmc.support"
        assert parent_of["eloc.sector"] == "vmc.local_energy"
        assert parent_of["fused_matrix_elements"] == "eloc.sector"
        assert parent_of["minsr_jacobians"] == "vmc.sr"
        kids = sum(s.device_ms for s in mine if s.parent == root)
        assert kids <= rec.spans[root].device_ms
    summary = rec.summary(2)
    assert summary["vmc.step"]["calls"] == 1.0
    assert summary["vmc.update"]["calls"] == 2.0
    assert summary["fused_matrix_elements"]["counts"] == {"rows": 64.0}
    for name, e in summary.items():
        assert 0.0 <= e["self_ms"] <= e["device_ms"] + 1e-9, name
        assert e["device_ms"] == e["host_ms"]  # the CPU: the host clock


def test_exact_step_names_the_static_path(n2):
    """Exact summation: no ``vmc.sample``; the static membership path is
    a span of its own under ``vmc.local_energy``."""
    v = tiny_vmc(n2, sampling_mode="exact", sr=None)
    state = v.init_state()
    with spans.recording() as rec:
        v.step(state)
    names = [s.name for s in rec.spans]
    assert "vmc.sample" not in names and "vmc.sr" not in names
    static = names.index("eloc.static")
    assert rec.spans[rec.spans[static].parent].name == "vmc.local_energy"


def _h2o_batch(n, rows=96, active=14, seed=5):
    """``rows`` random determinants on the first ``active`` of ``n``
    qubits, ~10% invalid, sorted, duplicates invalid (the prefilter
    tests' batch)."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((rows, n), dtype=np.int64)
    bits[:, :active] = rng.integers(0, 2, (rows, active))
    words = bitops.pack(torch.from_numpy(bits))
    valid = torch.from_numpy(rng.random(rows) < 0.9)
    words = torch.where(valid[:, None], words, bitops.MASK32)
    words, _, valid = keys.sort_words(words, valid)
    valid = valid & keys.unique_mask(words)
    la = torch.from_numpy(-np.abs(rng.standard_normal(rows)).astype(
        np.float32))
    ph = torch.from_numpy(rng.standard_normal(rows).astype(np.float32))
    return words, la, ph, valid


def test_prefilter_stages_once_a_row_block():
    """H2O in 40-row blocks (96 rows: 3 blocks), capacities (2, 96): stages
    1, 2 and 3a once a block, the build, 3b and the merge once; stage 1
    counts rows x M partners; kernel #2 answers B x c_row queries in 3a
    and the dense buffer's rows x M in 3b."""
    mol, eng = _h2o_engine()
    words, la, ph, valid = _h2o_batch(mol.qubit_num)
    m = eng.n_groups
    with spans.recording() as rec:
        eng.local_energy_proxy(words, la, ph, valid)
    order = [s.name for s in rec.spans if s.parent is None]
    assert order == ["pf.build"] + ["pf.stage1", "pf.stage2",
                                    "pf.stage3a"] * 3 + ["pf.stage3b",
                                                         "pf.merge"]
    summary = rec.summary(1)
    assert summary["pf.stage1"]["counts"] == {"partners": 96 * m}
    queries = [(rec.spans[s.parent].name, s.counts["queries"])
               for s in rec.spans if s.name == "hash_lookup"]
    assert queries == [("pf.stage3a", 40 * 2), ("pf.stage3a", 40 * 2),
                       ("pf.stage3a", 16 * 2), ("pf.stage3b", 96 * m)]
    assert summary["hash_lookup"]["counts"]["queries"] == 96 * 2 + 96 * m
    assert summary["hash_lookup"]["counts"]["launches"] == 4


def test_stage1_filter_counts_once_a_row_block():
    """Kernel #3's path in the same recorded call: one ``fp_filter`` span
    inside each ``pf.stage1``, counting its launch and its tier (H2O's
    table, nb 256 x E 32 = 32 KB, in shared memory); the block's partners
    are the enclosing stage's."""
    mol, eng = _h2o_engine()
    words, la, ph, valid = _h2o_batch(mol.qubit_num)
    m = eng.n_groups
    with spans.recording() as rec:
        eng.local_energy_proxy(words, la, ph, valid)
    got = [(rec.spans[s.parent].name, rec.spans[s.parent].counts, s.counts)
           for s in rec.spans if s.name == "fp_filter"]
    assert got == [("pf.stage1", {"partners": rows * m},
                    {"fp_launches": 1, "fp_smem_launches": 1})
                   for rows in (40, 40, 16)]


def _h2o_engine():
    mol = Molecule.create(MolConfig(name="H2O"), mols_dir=MOLS,
                          run_fci=False, run_cisd=False, device="cpu")
    return mol, PauliEngine(mol.qubit_ham, device="cpu",
                            membership="prefilter",
                            prefilter_row_capacity=2,
                            prefilter_dense_rows=96, pf_row_chunk=40)


def test_chip_smoke_counts_kernel3_operations():
    """``chip_smoke.fp_filter_ops``: the INT32-pipe instructions and the
    multiplies a partner that the kernel's SASS takes for its hashing and
    compares, 46 and 11 at a Cr2 row block's layout (K 3, E 16), 51 and 5
    at the C2H4 layout (K 2, E 32; one-word keys hash as two)."""
    import chip_smoke

    assert chip_smoke.fp_filter_ops(3, 16) == (46, 11)
    assert chip_smoke.fp_filter_ops(1, 32) == chip_smoke.fp_filter_ops(
        2, 32) == (51, 5)


def test_plain_lookup_counts_its_queries():
    """Kernel #2's plain version inside a recording: one span with the
    launch's shape as counters."""
    nb, n = 256, 1000
    tab = torch.full((nb, 4 * ENTRIES), -1e30, dtype=torch.float32)
    q = torch.arange(n, dtype=torch.int32)
    with spans.recording() as rec:
        hash_lookup(tab, q)
    (s,) = rec.spans
    assert s.name == "hash_lookup" and s.parent is None
    assert s.counts == {"launches": 1, "queries": n, "key_words": n,
                        "buckets": nb, "entries": nb * ENTRIES,
                        "table_words": nb * 4 * ENTRIES}


def test_profiler_trace_holds_the_spans(n2, tmp_path, monkeypatch):
    """Under ``torch.profiler`` the step's spans are ``user_annotation``
    ranges of the exported trace and nothing more: no CUDA event, no sync
    debug mode; the step's counters add to ``profiled_counts``."""
    from torch.profiler import ProfilerActivity, profile

    v = tiny_vmc(n2)
    state = v.init_state()
    v.step(state)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", _refuse)
    rows = spans.profiled_counts().get("rows", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        v.step(state)
    assert spans.profiled_counts()["rows"] - rows == 64
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"}
    assert {"vmc.step", "vmc.sample", "eloc.sector"} | STAGES <= ranges
    v.step(state)  # unprofiled: nothing more is counted
    assert spans.profiled_counts()["rows"] - rows == 64


class _FakeEvent:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_syncs_are_put_down_to_the_innermost_span(monkeypatch):
    """A recording on a CUDA device turns the sync debug mode to 'warn'
    while a step is open, counts each synchronizing call's warning against
    the innermost open span (and shows it not), passes other warnings on,
    and puts the mode back when the step closes."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    sync = spans.SYNC_WARNING + " (Triggered internally)"
    with spans.recording("cuda") as rec:
        with spans.span("step"):
            assert modes[-1] == "warn"
            warnings.warn(sync)
            with spans.span("inner"):
                warnings.warn(sync)
                warnings.warn(sync)
            with pytest.warns(UserWarning, match="another"):
                warnings.warn("another warning")
        assert modes[-1] == 0
    summary = rec.summary()
    assert summary["step"]["syncs"] == 1 and summary["inner"]["syncs"] == 2
    assert rec.cuda and summary["inner"]["device_ms"] >= 0.0


def _tiny_transformer(mol, qpq=4, **cfg):
    """N2's ANQS with d_model 16, 2 layers, 2 heads, d_ff 32 decoders."""
    from anqs_quantum_chemistry_torch.experiments.preparation import (
        create_masker,
    )
    from anqs_quantum_chemistry_torch.models.anqs import ANQS
    from anqs_quantum_chemistry_torch.symmetries import QubitGrouping

    return ANQS(QubitGrouping.create(create_masker(mol, "e_num_spin"), qpq),
                AnqsConfig(net_type="transformer", d_model=16, n_layers=2,
                           n_heads=2, d_ff=32, **cfg),
                generator=torch.Generator().manual_seed(4))


def test_transformer_forward_counts_rows_and_positions(n2):
    """``ANQS.log_psi`` on a transformer: one ``tx.forward`` a decoder
    (main, then aux), each counting its rows and rows x Q positions."""
    anqs = _tiny_transformer(n2)
    words = torch.zeros((37, 1), dtype=torch.int64)
    with spans.recording() as rec, torch.no_grad():
        anqs.log_psi(words)
    forwards = [s for s in rec.spans if s.name == "tx.forward"]
    assert len(forwards) == 2 and anqs.qudit_num == 5
    for s in forwards:
        assert s.counts == {"tx_rows": 37, "tx_positions": 37 * 5}
    assert rec.summary(1)["tx.forward"]["counts"] == {
        "tx_rows": 74.0, "tx_positions": 370.0}


def _count_draw(anqs, k, flip):
    """Draw ``k`` rows under a recording, under a profiler and with spans
    off, checking ``tx_sample_positions`` against the frontier's rows:
    one position a row in one ``tx.decode`` a qudit with the cache, Q a
    row, twice, in two ``tx.forward`` a qudit under ``spin_flip_abs``."""
    from torch.profiler import ProfilerActivity, profile

    from anqs_quantum_chemistry_torch.sampling.sampler import (
        gumbel_top_k_sample,
        uniform_shapes,
    )

    rows = [r for r, _ in uniform_shapes(anqs, k)]
    assert rows[:2] == [1, 16] and rows[-1] == k
    want = sum(rows) * (2 * anqs.qudit_num if flip else 1)
    gen = torch.Generator().manual_seed(1)
    with spans.recording() as rec, spans.span("draw"):
        gumbel_top_k_sample(anqs, k, gen)
    assert rec.spans[0].counts == {"tx_sample_positions": want}
    steps = [s for s in rec.spans
             if s.name == ("tx.forward" if flip else "tx.decode")]
    assert all(rec.spans[s.parent].name == "draw" for s in steps)
    if flip:
        assert [s.counts["tx_rows"] for s in steps[::2]] == rows
        assert [s.counts["tx_rows"] for s in steps[1::2]] == rows
    else:
        assert [s.counts for s in steps] == [
            {"tx_rows": r, "tx_positions": r} for r in rows]
        assert not any(s.name == "tx.forward" for s in rec.spans)
    before = spans.profiled_counts().get("tx_sample_positions", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        gumbel_top_k_sample(anqs, k, gen)
    after = spans.profiled_counts()["tx_sample_positions"]
    assert after - before == want
    gumbel_top_k_sample(anqs, k, gen)
    assert spans.profiled_counts()["tx_sample_positions"] == after


@pytest.mark.parametrize("k", [64, 300])
def test_gumbel_draw_counts_the_positions_it_computes(n2, k):
    """A Gumbel draw on a transformer counts ``tx_sample_positions``: at
    each qudit the incoming frontier's rows times the one position the
    main decoder runs against its key/value cache, in one ``tx.decode``
    a qudit carrying the frontier's rows -- against the span open around
    the draw under a recording, by name under a profiler; nothing when
    off."""
    _count_draw(_tiny_transformer(n2), k, flip=False)


def test_flip_averaged_draw_counts_every_position(n2):
    """Under ``spin_flip_abs`` the draw recomputes every position of the
    row and of its flip: 2Q positions a frontier row a qudit."""
    _count_draw(_tiny_transformer(n2, spin_flip_abs=True), 64, flip=True)


def test_spans_off_are_the_shared_null_context(n2, monkeypatch):
    """Off, ``span()`` hands back one shared null context and ``count()``
    records nothing; a transformer's forward and draw create no CUDA
    event, enter no ``record_function`` and read no clock."""
    from anqs_quantum_chemistry_torch.sampling.sampler import (
        gumbel_top_k_sample,
    )

    assert spans.span("tx.forward") is spans.span("other") is spans._OFF
    before = spans.profiled_counts()
    spans.count("tx_rows", 5)
    assert spans.profiled_counts() == before
    anqs = _tiny_transformer(n2)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(time, "perf_counter", _refuse)
    out = gumbel_top_k_sample(anqs, 32, torch.Generator().manual_seed(2))
    with torch.no_grad():
        la, _ = anqs.log_psi(out.words)
    assert torch.isfinite(la[out.valid]).all()
    assert spans.profiled_counts() == before
