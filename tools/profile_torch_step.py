"""Where the time of one training step of the PyTorch port goes, on one card.

Usage: python tools/profile_torch_step.py [reps] [n2|li2o]

Builds a training workload -- ``n2`` (default): the main path,
``experiments.vmc.main_path_vmc`` (N2, MADE 512, 14464 Gumbel samples,
sector membership, MinSR top-50); ``li2o``: the toy model,
``experiments.vmc.li2o_vmc`` (Li2O, MADE 512, 8192 Gumbel samples, hash
membership, MinSR top-50) -- warms it up with 3 steps, then
times ``reps`` whole steps on the host clock, and each stage of the step
on its own with CUDA events, ``reps`` times each (mean ms), the way the
JAX package's ``VMC.profile_stages`` splits a step. It then traces
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


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from anqs_quantum_chemistry_torch.experiments.vmc import (
        li2o_vmc,
        main_path_vmc,
    )
    from anqs_quantum_chemistry_torch.ops.hash_lookup import hash_lookup
    from anqs_quantum_chemistry_torch.optim.sr import sr_transform
    from anqs_quantum_chemistry_torch.sampling.sampler import sample

    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: needs a CUDA device")
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    workload = sys.argv[2] if len(sys.argv) > 2 else "n2"
    vmc = {"n2": main_path_vmc, "li2o": li2o_vmc}[workload]("cuda")
    state = vmc.init_state()
    for _ in range(3):
        vmc.step(state)
    torch.cuda.synchronize()

    anqs, eng, cfg = vmc.anqs, vmc.engine, vmc.config
    words, weights, valid, _, la, ph, e = vmc._support_and_eloc(state)
    params = dict(anqs.named_parameters())

    def loss_backward():
        la_g, ph_g = anqs.log_psi(words)
        loss = torch.sum(weights * (la_g * e.e_re + ph_g * e.e_im))
        return torch.autograd.grad(loss, list(params.values()))

    grads = dict(zip(params, loss_backward()))
    stages = {}
    with torch.no_grad():
        stages["sample_ms"] = cuda_ms(
            lambda: sample(anqs, vmc.sampling_config, state.generator), reps)
        stages["log_psi_ms"] = cuda_ms(lambda: anqs.log_psi(words), reps)
        stages["matrix_elements_ms"] = cuda_ms(
            lambda: eng.matrix_elements(words), reps)
        if vmc.sector_words is not None:
            stages["local_energy_sector_ms"] = cuda_ms(
                lambda: eng.local_energy_sector(
                    words, la, ph, valid, vmc.sector_words,
                    vmc.sector_partner_idx, vmc.sector_partner_found,
                    sector_pos=vmc.sector_pos), reps)
        else:
            stages["local_energy_proxy_ms"] = cuda_ms(
                lambda: eng.local_energy_proxy(words, la, ph, valid), reps)
            stages["hash_build_ms"] = cuda_ms(
                lambda: eng._hash_build(words, la, ph, valid), reps)
            tab = eng._hash_build(words, la, ph, valid)[0]
            queries = eng._hash_queries(words)
            stages["hash_lookup_ms"] = cuda_ms(
                lambda: hash_lookup(tab, *queries), reps)
    stages["loss_fwd_bwd_ms"] = cuda_ms(loss_backward, reps)
    stages["minsr_ms"] = cuda_ms(
        lambda: sr_transform(anqs, params, grads, words, weights, cfg.sr),
        reps)

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
        "reps": reps,
        "step_ms": step_ms, "step_wall_ms_profiled": wall_ms,
        "device_busy_ms": device_ms,
        "busy_share_profiled": device_ms / wall_ms,
        "busy_share_unprofiled": device_ms / step_ms,
        **stages,
    }))


if __name__ == "__main__":
    main()
