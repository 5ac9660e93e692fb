#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``anqs_quantum_chemistry_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and ``nvcc``.
It builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain PyTorch version on the card at the main path's
shapes and times both, then trains the main-path workload -- N2/STO-3G,
MADE (512 hidden, 10 qubits per qudit), Gumbel top-k sampling of the whole
14400-determinant sector (14464 rows), sector membership, MinSR top-50, clip
1.0, Adam 1e-3 -- for 5 steps from random weights (seed 0) through
``VMC(...)``, ``init_state()`` and ``step()``, and checks the energies
against the exact sector Hamiltonian.

Every line is flushed as it is printed. The line before the last is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``; any failed
check exits non-zero before either. Imports torch, numpy, scipy and the
port only.
"""

import json
import os
import re
import subprocess
import sys
import time

T_START = time.monotonic()
TIME_LIMIT_S = 300.0
ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 5
ME_TOL = 1e-6  # kernel vs plain version: same rounding contract
# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


class SmokeFailure(Exception):
    pass


def log(msg=""):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps, warmup=3):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_phase(torch, mol, words):
    from anqs_quantum_chemistry_torch.chem.fci import sector_matrix_elements
    from anqs_quantum_chemistry_torch.ops import bits
    from anqs_quantum_chemistry_torch.ops.matrix_elements import (
        build_tables,
        fused_matrix_elements,
        matrix_elements_plain,
        plain_operands,
    )

    ham = mol.qubit_ham
    tables = build_tables(ham, "cuda")
    me = fused_matrix_elements(words, tables)
    plain = matrix_elements_plain(words, tables)
    torch.cuda.synchronize()
    check(me.shape == (words.shape[0], ham.n_groups), f"shape {me.shape}")
    check(bool(torch.isfinite(me).all()), "non-finite matrix elements")
    err = float((me - plain).abs().max())
    log(f"kernel fused_matrix_elements: B={words.shape[0]} "
        f"T={ham.n_terms} M={ham.n_groups} max|kernel - plain| = {err:.3e}"
        f" Ha (tol {ME_TOL:g})")
    check(err <= ME_TOL, f"kernel disagrees with plain version: {err}")

    # Float64 host reference on the first rows (one float32 rounding).
    rows = 512
    dets = words[:rows, 0].cpu().numpy().astype("uint64")
    ref = torch.from_numpy(sector_matrix_elements(ham, dets))
    got = me[:rows].cpu().double()
    ref_err = float(((got - ref).abs() - 2.4e-7 * ref.abs()).max())
    log(f"kernel vs float64 host reference ({rows} rows): max excess over "
        f"one float32 ulp = {ref_err:.3e} Ha")
    check(ref_err <= 1e-6, "kernel disagrees with the float64 reference")

    # Yardstick (never called by the port): the dense two-matmul form.
    x = bits.unpack(words, ham.qubit_num, dtype=torch.float32)
    b_bits, group_splits = plain_operands(tables)
    dense = group_splits.to(torch.float32).sum(0)

    def library():
        p = x @ b_bits
        return (1.0 - 2.0 * torch.remainder(p, 2.0)) @ dense

    lib_err = float((library() - me).abs().max())
    ms = cuda_ms(lambda: fused_matrix_elements(words, tables), reps=50)
    plain_ms = cuda_ms(lambda: matrix_elements_plain(words, tables), reps=5)
    library_ms = cuda_ms(library, reps=10)

    n_rows, n_terms, n_groups = words.shape[0], ham.n_terms, ham.n_groups
    n_bytes = (words.numel() * 8 + tables.b_words.numel() * 8
               + tables.splits.numel() * 2 + tables.group_starts.numel() * 4
               + n_rows * n_groups * 4)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * n_rows * n_terms / FP32_FLOP_PER_S * 1e3
    log(f"kernel timing: {ms:.4f} ms, plain {plain_ms:.4f} ms, dense "
        f"two-matmul library form {library_ms:.4f} ms (max|lib - kernel| = "
        f"{lib_err:.3e}); bound {max(bytes_ms, ops_ms) * 1e3:.2f} us "
        f"({n_bytes / 1e6:.1f} MB moved, {2 * n_rows * n_terms / 1e6:.0f} "
        "MFLOP)")
    return {
        "name": "fused_matrix_elements",
        "route": "cuda",
        "source": "anqs_quantum_chemistry_torch/csrc/fused_me.cu",
        "replaces": "anqs_quantum_chemistry_tpu/ops/pallas_kernels.py:100",
        "launches": None,
        "max_abs_err": err,
        "tol": ME_TOL,
        "ok": True,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def trainer_phase(torch, mol, device="cuda", width=512):
    """5 steps of the main path; returns the kernel launches they made."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.fci import sector_hamiltonian
    from anqs_quantum_chemistry_torch.experiments.vmc import main_path_vmc
    from anqs_quantum_chemistry_torch.ops.matrix_elements import (
        fused_matrix_elements,
    )

    t0 = time.perf_counter()
    vmc = main_path_vmc(device=device, hidden_width=width)
    state = vmc.init_state()
    log(f"trainer set-up: {time.perf_counter() - t0:.2f} s")

    # Reference for the first step's energy: the Rayleigh quotient of the
    # initial weights over the whole sector, with the float64 sector
    # Hamiltonian built on the host from the Pauli terms.
    n_real = mol.fci_ndet
    sector = vmc.sector_words[:n_real]
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(sector)
    psi = np.exp(la.double().cpu().numpy() + 1j * ph.double().cpu().numpy())
    dets = sector[:, 0].cpu().numpy().astype(np.uint64)
    h = sector_hamiltonian(mol.qubit_ham, dets)
    e_ref = float(np.real(np.vdot(psi, h @ psi)) / np.vdot(psi, psi).real)

    fused_matrix_elements.launches = 0
    rows = []
    for i in range(STEPS):
        t = time.perf_counter()
        row = vmc.step(state)
        dt = time.perf_counter() - t
        rows.append(row)
        log(f"step {i}: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"grad_norm {row['grad_norm']:.4f} step_s {dt:.4f} "
            f"me_launches {fused_matrix_elements.launches}")
    launches = fused_matrix_elements.launches

    e_fci = mol.fci_energy
    log(f"E_FCI {e_fci:.6f}; step-0 Rayleigh quotient reference "
        f"{e_ref:.6f} (|step 0 - ref| = {abs(rows[0]['energy'] - e_ref):.2e}"
        " Ha)")
    for i, row in enumerate(rows):
        check(int(row["unique_num"]) == n_real,
              f"step {i}: unique_num {row['unique_num']} != {n_real}")
        check(np.isfinite(row["energy"]), f"step {i}: energy not finite")
        check(row["energy"] >= e_fci - 1e-5,
              f"step {i}: energy {row['energy']} below E_FCI {e_fci}")
    # float32 amplitudes and matrix elements against float64: ~1e-6
    # relative at |E| ~ 100 Ha.
    check(abs(rows[0]["energy"] - e_ref) <= 1e-4,
          "step-0 energy disagrees with the Rayleigh quotient")
    check(launches == STEPS,
          f"matrix-element kernel launched {launches} times in {STEPS} steps")
    return launches


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from anqs_quantum_chemistry_torch.chem.molecule import load_n2
    from anqs_quantum_chemistry_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (count {torch.cuda.device_count()}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t = time.perf_counter()
    build_logs = cuda_build.build(["fused_me"])
    log(f"build: {time.perf_counter() - t:.2f} s")
    for name, text in build_logs.items():
        instance = name
        for line in text.splitlines():
            # ptxas -v names each entry function (mangled) before its
            # resource lines; label those by the kernel's template argument.
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                words_arg = re.search(r"ILi(\d+)E", found.group(1))
                instance = (f"{name}<W={words_arg.group(1)}>" if words_arg
                            else found.group(1))
            elif "registers" in line or "spill" in line:
                log(f"  {instance}: {line.strip()}")

    mol = load_n2()
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.fci import sector_determinants

    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    words = np.concatenate([dets, np.full(64, 0xFFFFFFFF, np.uint64)])
    words = torch.from_numpy(words.astype(np.int64)[:, None]).cuda()
    entry = kernel_phase(torch, mol, words)
    entry["launches"] = trainer_phase(torch, mol)

    elapsed = time.monotonic() - T_START
    log(f"total: {elapsed:.1f} s")
    check(elapsed < TIME_LIMIT_S, f"took {elapsed:.0f} s")
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
