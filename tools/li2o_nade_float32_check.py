"""The JAX package and the port side by side on the CPU, in float32, on the
Li2O NADE campaign (runs where JAX does, not on the card).

    python tools/li2o_nade_float32_check.py pretrain0
    python tools/li2o_nade_float32_check.py leg jax|port SAMPLES ITERS

``pretrain0``: the loss of the first CISD pretraining step from the JAX
package's initial weights (seed 0), in both packages, beside the JAX
campaign's TPU record (``runs/logs/li2o_nade_t2.log``: 32.49424).
``leg``: the distillation leg of ``examples/li2o_distill_closure.py``
(tau 0.1, 100 steps at 1e-4 every 10 iterations, Adam 3e-5, T 2, MinSR
top 50, prefilter capacities (768, 4096)) from the JAX closure state, in
one package, at SAMPLES Gumbel samples for ITERS iterations, in windows
of 10; prints every cycle's row and the one after it.
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


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["pretrain0"]:
        pretrain0()
    elif sys.argv[1:2] == ["leg"] and len(sys.argv) == 5:
        leg(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        sys.exit(__doc__)
