"""One training step of the JAX package and of the PyTorch port from the
same weights and sampler uniforms, for the option parity tests
(``test_torch_ansatz_options.py``, ``test_torch_spin_flip.py``,
``test_torch_qubit_perm.py``, ``test_torch_spin_systems.py``). The step is
SGD at lr 1, so the JAX update is minus its gradient."""

import jax
import jax.numpy as jnp
import numpy as np

from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.sampling.sampler import uniform_shapes
from torch_port_common import jax_uniforms, molecules, to_np


def step_pair(name, cfg, acfg, jax_cfg=None, sign_structure=None):
    """(JAX VMC, port VMC, JAX metrics, port metrics, port gradients, JAX
    gradients) of one step on molecule ``name``: ``cfg`` the VMCConfig
    fields of both (SGD at lr 1 added), ``acfg`` the AnqsConfig fields,
    ``jax_cfg`` JAX-only VMCConfig fields; ``sign_structure`` is set on
    JAX's ansatz as its ``_const_targets`` expect and given to the port's
    trainer."""
    jmol, mol = molecules(name)
    cfg = dict(cfg, opt_type="sgd", lr=1.0)
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(
        engine_overrides={"table_pairs_per_row": 1}, **cfg,
        **(jax_cfg or {})), JaxAnqsConfig(**acfg))
    v = VMC(mol, VMCConfig(**cfg), AnqsConfig(**acfg), device="cpu",
            sign_structure=sign_structure)
    if sign_structure is not None:
        jv.anqs.sign_structure = jnp.asarray(sign_structure)
    return _step_both(jv, v, cfg)


def step_pair_explicit(jax_system, system, cfg, acfg):
    """``step_pair`` on an explicit Hamiltonian: ``jax_system`` and
    ``system`` are the ``ham``, ``masker`` and ``ref_det`` keywords of the
    JAX and the port ``VMC``."""
    cfg = dict(cfg, opt_type="sgd", lr=1.0)
    jv = jvmc.VMC(config=jvmc.VMCConfig(
        engine_overrides={"table_pairs_per_row": 1}, **cfg),
        anqs_config=JaxAnqsConfig(**acfg), **jax_system)
    v = VMC(config=VMCConfig(**cfg), anqs_config=AnqsConfig(**acfg),
            device="cpu", **system)
    return _step_both(jv, v, cfg)


def _step_both(jv, v, cfg):
    """One step of each trainer from JAX's initial weights and uniforms."""
    p0, o0, key = jv.init_state()
    state = v.init_state()
    v.anqs.load_state_dict(params_from_jax(to_np(p0)))
    p1, _, _, jm = jv._step(p0, o0, key)
    uniforms = None
    if cfg.get("sampling_mode") != "exact":
        _, sample_key = jax.random.split(key)
        uniforms = jax_uniforms(sample_key, uniform_shapes(
            v.anqs, cfg["sample_num"]))
    metrics, grads = v._grads_and_metrics(state, uniforms)
    want = params_from_jax(to_np(jax.tree.map(lambda a, b: a - b, p0, p1)))
    return jv, v, jm, metrics, grads, want


def assert_step_matches(jm, metrics, grads, want,
                        names=("energy", "energy_var")):
    """Gradients rtol 1e-4 (atol 1e-6), the same pairs and set size, and
    ``names`` to 1e-6 (Ha)."""
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert int(metrics["found_pairs"]) == int(jm["found_pairs"])
    assert int(metrics["unique_num"]) == int(jm["unique_num"])
    for name in names:
        assert abs(float(metrics[name]) - float(jm[name])) < 1e-6, name
