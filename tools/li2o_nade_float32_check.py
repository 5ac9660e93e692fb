"""The JAX package and the port side by side on the CPU, in float32, on the
Li2O NADE campaign (runs where JAX does, not on the card).

    python tools/li2o_nade_float32_check.py pretrain0
    python tools/li2o_nade_float32_check.py leg jax|port SAMPLES ITERS
    python tools/li2o_nade_float32_check.py cisd SAMPLES ITERS [OUT.csv]

``pretrain0``: the loss of the first CISD pretraining step from the JAX
package's initial weights (seed 0), in both packages, beside the JAX
campaign's TPU record (``runs/logs/li2o_nade_t2.log``: 32.49424).
``leg``: the distillation leg of ``examples/li2o_distill_closure.py``
(tau 0.1, 100 steps at 1e-4 every 10 iterations, Adam 3e-5, T 2, MinSR
top 50, prefilter capacities (768, 4096)) from the JAX closure state, in
one package, at SAMPLES Gumbel samples for ITERS iterations, in windows
of 10; prints every cycle's row and the one after it.
``cisd``: the CISD leg of ``examples/cisd_pretrain_vmc.py`` for Li2O (NADE
(128, 128), qubit_per_qudit 6, Born weights, gradient temperature 2) in the
JAX package on the CPU, in float32: the JAX package's CISD vector, its
initial weights (seed 0; the same as ``tools/export_jax_params.py
--init``), the example's three full-batch pretraining stages (7000 steps:
the 4425 determinants fit one batch, so no draw is random), then ITERS VMC
iterations at SAMPLES Gumbel samples in windows of 25. Prints the rows
every 25 iterations and writes every row to OUT.csv; its card counterpart
is ``tools/li2o_nade_diagnostics.py cisd ITERS --init FILE --precision P``.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

NADE = dict(net_type="nade", hidden_widths=(128, 128),
            aux_hidden_widths=(128, 128))
PREFILTER = {"prefilter_row_capacity": 768, "prefilter_dense_rows": 4096}
TPU_RECORD_LOSS0 = 32.49424


def jax_molecule():
    from anqs_quantum_chemistry_tpu.chem.molecule import Molecule, MolConfig

    return Molecule.create(MolConfig(name="Li2O"),
                           mols_dir=os.path.join(ROOT, "mols"),
                           run_fci=False, run_cisd=False)


def pretrain0():
    import jax

    from anqs_quantum_chemistry_tpu.optim import pretrain as jax_pretrain
    from anqs_quantum_chemistry_torch.chem.fci import cisd_ground_state
    from anqs_quantum_chemistry_torch.convert import params_from_jax
    from anqs_quantum_chemistry_torch.experiments.vmc import li2o_nade_vmc
    from anqs_quantum_chemistry_torch.optim import pretrain as port_pretrain
    from export_jax_params import flatten, li2o_nade_init_params

    params = li2o_nade_init_params()
    vmc = li2o_nade_vmc(device="cpu")
    _, dets, coef = cisd_ground_state(vmc.ham, vmc.mol.hf_det)
    probs, phases = port_pretrain.amplitude_targets_from_coefs(coef)
    from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
    from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig

    jv = jvmc.VMC(jax_molecule(), jvmc.VMCConfig(qubit_per_qudit=6, seed=0),
                  AnqsConfig(**NADE))
    jwords = jax_pretrain.pack_dets([int(d) for d in dets], 30)
    _, jhist = jax_pretrain.pretrain(jv.anqs, params, jwords, probs, phases,
                                     jax.random.PRNGKey(0), iters=1,
                                     batch=len(dets))
    vmc.anqs.load_state_dict(params_from_jax(flatten(params)))
    _, hist = port_pretrain.pretrain(vmc.anqs, port_pretrain.pack_dets(
        dets, 30), probs, phases, iters=1, batch=len(dets))
    print(f"pretraining loss at step 0 from JAX's initial weights: JAX "
          f"(CPU) {jhist[0]['loss']:.5f}, port (CPU) {hist[0]['loss']:.5f}, "
          f"the JAX campaign's TPU record {TPU_RECORD_LOSS0:.5f}")


def leg(which, samples, iters):
    from anqs_quantum_chemistry_torch.experiments.vmc import (
        li2o_nade_closure_params,
    )

    cfg = dict(sample_num=samples, sampling_mode="gumbel", qubit_per_qudit=6,
               lr=3e-5, grad_clip_norm=0.5, grad_weight_temperature=2.0,
               distill_period=10, distill_steps=100, distill_tau=0.1,
               distill_lr=1e-4, distill_loss="ce", seed=0, iter_num=iters)
    params = li2o_nade_closure_params()
    t0 = time.perf_counter()

    def progress(it, row):
        if it % 10 in (0, 1):
            print(f"{which} {it} E {row['energy']:.6f} var "
                  f"{row['energy_var']:.3g} distill_loss "
                  f"{row['distill_loss_first']:.5f} -> "
                  f"{row['distill_loss_last']:.5f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    if which == "jax":
        import jax.numpy as jnp

        from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
        from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig
        from anqs_quantum_chemistry_tpu.optim.sr import SRConfig

        tree = {}
        for name, value in params.items():
            net, q, leaf = name.split(".")
            tree.setdefault(net, {}).setdefault(q, {})[leaf] = jnp.asarray(
                value.numpy())
        jv = jvmc.VMC(jax_molecule(), jvmc.VMCConfig(
            sr=SRConfig(max_indices_num=50), engine_overrides=PREFILTER,
            **cfg), AnqsConfig(**NADE))
        jv.run(iters, on_iter=progress, checkpoint_every=None,
               steps_per_call=10, init_params=tree)
    else:
        from anqs_quantum_chemistry_torch.chem.molecule import load_li2o
        from anqs_quantum_chemistry_torch.experiments.vmc import (
            LI2O_NADE,
            VMC,
            VMCConfig,
        )
        from anqs_quantum_chemistry_torch.optim.sr import SRConfig

        v = VMC(load_li2o(), VMCConfig(sr=SRConfig(max_indices_num=50),
                                       engine_overrides=PREFILTER, **cfg),
                LI2O_NADE, device="cpu")
        v.run(iters, on_iter=progress, checkpoint_every=None,
              steps_per_call=10, init_params=params, log_every=0)


def cisd_leg(samples, iters, out=None):
    import csv

    import jax

    from anqs_quantum_chemistry_tpu.chem import fci as jfci
    from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
    from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig
    from anqs_quantum_chemistry_tpu.optim import pretrain as jpre
    from anqs_quantum_chemistry_tpu.optim.sr import SRConfig

    mol = jax_molecule()
    t0 = time.perf_counter()
    e, dets, coef = jfci.cisd_ground_state(mol.h1, mol.v, int(mol.hf_det),
                                           mol.e_nuc)
    print(f"CISD: {len(dets)} dets, E {e:.9f} "
          f"[{time.perf_counter() - t0:.0f}s]", flush=True)
    probs, phases = jpre.amplitude_targets_from_coefs(coef)
    words = jpre.pack_dets(dets, mol.qubit_num)
    jv = jvmc.VMC(mol, jvmc.VMCConfig(
        sample_num=samples, sampling_mode="gumbel", qubit_per_qudit=6,
        lr=3e-4, lr_schedule=((0, 3e-4), (1500, 1e-4), (3000, 3e-5)),
        grad_clip_norm=0.5, sr=SRConfig(max_indices_num=50),
        engine_overrides=PREFILTER, seed=0, iter_num=iters,
        use_theor_freqs=True, grad_weight_temperature=2.0),
        AnqsConfig(**NADE))
    params, _, _ = jv.init_state()
    t0 = time.perf_counter()

    def plog(row):
        if row["iter"] % 500 == 0:
            print(f"  pretrain {row['iter']:5d} loss {row['loss']:.5f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    for stage_iters, lr in ((2500, 1e-3), (2500, 3e-4), (2000, 1e-4)):
        params, _ = jpre.pretrain(jv.anqs, params, words, probs, phases,
                                  jax.random.PRNGKey(0), iters=stage_iters,
                                  lr=lr, batch=min(8192, len(dets)),
                                  on_log=plog)
    rows = []

    def progress(it, row):
        rows.append({"iter": it, **row})
        if it % 25 == 0:
            print(f"iter {it} E {row['energy']:.6f} var "
                  f"{row['energy_var']:.4g} found {int(row['found_pairs'])} "
                  f"unique {int(row['unique_num'])} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    t0 = time.perf_counter()
    jv.run(iters, on_iter=progress, checkpoint_every=None, steps_per_call=25,
           init_params=params)
    if out:
        with open(out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    energies = np.array([r["energy"] for r in rows])
    print(f"found_pairs after pretraining {int(rows[0]['found_pairs'])}; "
          f"mean energy over iterations 1-{iters - 1} "
          f"{energies[1:].mean():.6f}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["pretrain0"]:
        pretrain0()
    elif sys.argv[1:2] == ["cisd"] and len(sys.argv) in (4, 5):
        cisd_leg(int(sys.argv[2]), int(sys.argv[3]),
                 sys.argv[4] if len(sys.argv) == 5 else None)
    elif sys.argv[1:2] == ["leg"] and len(sys.argv) == 5:
        leg(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        sys.exit(__doc__)
