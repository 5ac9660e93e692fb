"""Where the time of one training step of the PyTorch port goes, on one card.

Usage: python tools/profile_torch_step.py [reps]
    [n2|li2o|c2h4|li2o_nade|cr2|n2_spin_flip|li2o_options]

Builds a training workload -- ``n2`` (default): the main path,
``experiments.vmc.main_path_vmc`` (N2, MADE 512, 14464 Gumbel samples,
sector membership, MinSR top-50); ``li2o``: the toy model,
``experiments.vmc.li2o_vmc`` (Li2O, MADE 512, 8192 Gumbel samples, hash
membership, MinSR top-50); ``c2h4``: ``experiments.vmc.c2h4_vmc`` (C2H4/
6-31G, the transformer, 4096 Gumbel samples and 2048 pinned HF
neighbours, prefilter membership, MinSR top-50); ``li2o_nade``:
``experiments.vmc.li2o_nade_vmc`` (Li2O, NADE (128, 128), 8192 Gumbel
samples, prefilter membership at capacities (768, 4096), MinSR top-50)
from the JAX package's closure state, which also times one distillation
cycle (100 supervised Adam steps) alone; ``cr2``:
``experiments.vmc.cr2_vmc`` (Cr2/SV, 84 qubits, MADE 1024, 1024 Gumbel
samples and 64 pinned HF neighbours, prefilter membership in 128-row
blocks, MinSR top-50; its prefilter stages are timed with the batch as
one block); ``n2_spin_flip``: the main path with both spin-flip flags and
the flip closure (``chip_smoke.py`` options (a)); ``li2o_options``: the
toy model with ``experiments.vmc.LI2O_OPTIONS``, ``topk_impl='bisect'`` and
MinSR without regularisation (options (d)) -- warms it up with 3
steps (and on until a step drops no rows, the overflow policy acting after
each step, as ``run`` does), then
times ``reps`` whole steps on the host clock, and each stage of the step
on its own by ``VMC.profile_stages(reps)`` (JAX's stages and keys, CUDA
events, mean ms); under prefilter membership also each prefilter stage
(``prefilter_stages``), under hash membership the table build and the
lookup, each alone with CUDA events. It then traces
``reps`` whole steps with ``torch.profiler`` and prints the kernels that
take the most device time and two busy shares: summed kernel time over the
profiled steps' wall time (which the profiler stretches), and the same
kernel time over the unprofiled step time. Prints one JSON line last.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuda_ms(fn, reps):
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def prefilter_stages(eng, words, la, ph, valid):
    """{stage: callable} of the prefilter membership's stages on one
    canonically sorted batch (``PauliEngine._proxy_via_prefilter`` at the
    engine's capacities, one row block), each callable running its stage
    alone on the stage's real inputs: the table build, stage 1 (the
    fingerprint pass), stage 2 (the per-row top-k compaction), stage 3a
    (query build, ``hash_lookup`` and the row sums of the B x c_row
    candidates), stage 3b (the dense rows' lookups, matrix elements and
    sums), and the two kernels alone at their shapes on this path: kernel
    #1 on the whole batch (3a) and on the dense rows (3b), and kernel #2
    on stage 3a's and stage 3b's queries. Also returns {stage: query
    count} of the two lookups and the dense rows' count."""
    import torch

    from anqs_quantum_chemistry_torch.ops.hash_lookup import (
        as_int32,
        hash_lookup,
    )

    m = eng.n_groups
    tab, nb, _, fptab = eng._hash_build(words, la, ph, valid, with_fp=True)
    hit = eng._fp_candidates(fptab, nb, words) & valid[:, None]
    c_row = min(eng.prefilter_row_capacity, m)
    keys_m = m - torch.arange(m, dtype=torch.int32, device=words.device)
    kvals, m_idx = torch.topk(torch.where(hit, keys_m, 0), c_row, dim=1)
    over = valid & (torch.sum(hit, dim=1) > c_row)
    _, row_ok, safe_rows = eng._dense_rows(over)
    rw = words[safe_rows]

    def queries(rows, idx=None):
        w32, a32 = as_int32(rows), as_int32(eng.a_words)
        return [(w32[:, None, i] ^ (a32[:, i][idx] if idx is not None
                                    else a32[None, :, i])).reshape(-1)
                for i in range(rows.shape[1])]

    q3a, q3b = queries(words, m_idx), queries(rw)

    def stage3a():
        la1, ph1, f1 = eng._lookup_rows(tab, words, m_idx)
        me = eng.matrix_elements(words)
        return eng._combine_rows(torch.gather(me, 1, m_idx), la1, ph1,
                                 f1 & (kvals > 0), ph)

    def stage3b():
        la2, ph2, f2 = eng._lookup_rows(tab, rw)
        return eng._combine_rows(eng.matrix_elements(rw), la2, ph2,
                                 f2 & row_ok[:, None], ph[safe_rows])

    stages = {
        "hash_build_ms": lambda: eng._hash_build(words, la, ph, valid,
                                                 with_fp=True),
        "stage1_fingerprint_ms": lambda: eng._fp_candidates(fptab, nb,
                                                            words),
        "stage2_compaction_ms": lambda: torch.topk(
            torch.where(hit, keys_m, 0), c_row, dim=1),
        "stage3a_verify_ms": stage3a,
        "stage3b_dense_ms": stage3b,
        "kernel1_me_ms": lambda: eng.matrix_elements(words),
        "kernel1_me_3b_ms": lambda: eng.matrix_elements(rw),
        "kernel2_3a_ms": lambda: hash_lookup(tab, *q3a,
                                             entries=eng.hash_epb),
        "kernel2_3b_ms": lambda: hash_lookup(tab, *q3b,
                                             entries=eng.hash_epb),
    }
    return stages, {"kernel2_3a": q3a[0].numel(),
                    "kernel2_3b": q3b[0].numel(), "rows_3b": rw.shape[0]}


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from anqs_quantum_chemistry_torch.experiments.vmc import (
        LI2O_OPTIONS,
        c2h4_vmc,
        cr2_vmc,
        li2o_nade_closure_params,
        li2o_nade_vmc,
        li2o_vmc,
        main_path_vmc,
    )
    from anqs_quantum_chemistry_torch.ops.hash_lookup import hash_lookup
    from anqs_quantum_chemistry_torch.optim.sr import SRConfig

    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: needs a CUDA device")
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    workload = sys.argv[2] if len(sys.argv) > 2 else "n2"

    def n2_spin_flip(device):
        return main_path_vmc(device, couple_spin_flip=True,
                             anqs_options=dict(spin_flip_abs=True,
                                               spin_flip_phase=True))

    def li2o_options(device):
        return li2o_vmc(device, anqs_options=LI2O_OPTIONS, topk_impl="bisect",
                        sr=SRConfig(max_indices_num=50, use_reg=False))

    vmc = {"n2": main_path_vmc, "li2o": li2o_vmc, "c2h4": c2h4_vmc,
           "li2o_nade": li2o_nade_vmc, "cr2": cr2_vmc,
           "n2_spin_flip": n2_spin_flip,
           "li2o_options": li2o_options}[workload]("cuda")
    state = vmc.init_state()
    if workload == "li2o_nade":
        vmc.anqs.load_state_dict(li2o_nade_closure_params())
    for i in range(3 + vmc.config.max_overflow_escalations):
        row = vmc.step(state)
        if i >= 2 and row["pf_dropped_rows"] + row["table_overflow"] == 0:
            break
        vmc._handle_overflow({**row, "iter_idx": i})
    torch.cuda.synchronize()

    eng = vmc.engine
    words, _, valid, _, la, ph, _ = vmc._support_and_eloc(state)
    # JAX's stages (``VMC.profile_stages``: sample, sort, log psi, matrix
    # elements, local energies, loss gradient, MinSR).
    stages = vmc.profile_stages(reps)
    stages.pop("device")
    with torch.no_grad():
        if vmc.sector_words is None:
            if eng.membership == "prefilter":
                fns, _ = prefilter_stages(eng, words, la, ph, valid)
                for name, fn in fns.items():
                    stages[f"prefilter_{name}"] = cuda_ms(fn, reps)
            else:
                stages["hash_build_ms"] = cuda_ms(
                    lambda: eng._hash_build(words, la, ph, valid), reps)
                tab = eng._hash_build(words, la, ph, valid)[0]
                queries = eng._hash_queries(words)
                stages["hash_lookup_ms"] = cuda_ms(
                    lambda: hash_lookup(tab, *queries,
                                        entries=eng.hash_epb), reps)
    if workload == "li2o_nade":
        dopt = vmc.make_distill_opt()
        stages["distill_cycle_ms"] = cuda_ms(
            lambda: vmc.distill_cycle(state, dopt), max(1, reps // 5))

    t0 = time.perf_counter()
    for _ in range(reps):
        vmc.step(state)  # ends in a synchronise (reads the metrics)
    step_ms = (time.perf_counter() - t0) * 1e3 / reps

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            vmc.step(state)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    # Kernel records only: an operator's own record repeats the device time
    # of the kernels it launched.
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and ev.self_device_time_total > 0]
    device_ms = sum(ev.self_device_time_total for ev in events) / 1e3 / reps
    print(f"step {step_ms:.3f} ms; profiled step {wall_ms:.3f} ms; kernel "
          f"time {device_ms:.3f} ms per step = "
          f"{100 * device_ms / wall_ms:.1f}% of the profiled step, "
          f"{100 * device_ms / step_ms:.1f}% of the unprofiled step")
    for name, ms in stages.items():
        print(f"  {name:26s} {ms:9.4f}")
    top = sorted(events, key=lambda ev: -ev.self_device_time_total)[:12]
    for ev in top:
        print(f"  {ev.self_device_time_total / 1e3 / reps:9.4f} ms  "
              f"x{ev.count // reps:<4d} {ev.key[:90]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "workload": workload,
        "reps": reps, "overflow_escalations": vmc._overflow_escalations,
        "step_ms": step_ms, "step_wall_ms_profiled": wall_ms,
        "device_busy_ms": device_ms,
        "busy_share_profiled": device_ms / wall_ms,
        "busy_share_unprofiled": device_ms / step_ms,
        **stages,
    }))


if __name__ == "__main__":
    main()
