"""The ranks' side of ``test_torch_parallel.py``: every scenario of the
data-parallel port on one rank of a gloo mesh on the CPU.

This module imports no JAX (the ranks are spawned processes that import it
to unpickle ``scenarios``); the test module computes the JAX references and
hands the ranks numpy inputs. ``scenarios(mesh, inputs)`` runs every
scenario named in ``inputs`` and returns its arrays, this rank's rows
where the result is sharded."""

import csv
import os

import numpy as np
import torch

from anqs_quantum_chemistry_torch.chem.molecule import Molecule
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments import dryrun_multichip
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import ANQS, AnqsConfig
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.parallel.dist_membership import (
    hash_membership_dist,
)
from anqs_quantum_chemistry_torch.parallel.mesh import (
    all_to_all,
    replicate,
    shard_rows,
)
from anqs_quantum_chemistry_torch.sampling.sampler import gumbel_top_k_sample
from anqs_quantum_chemistry_torch.symmetries import (
    Masker,
    QubitGrouping,
    particle_number_symmetry,
    spin_projection_symmetry,
)

# The memberships held on the mesh against one process on one set.
MESH_MEMBERSHIPS = ("table", "hash", "prefilter", "search", "hash_dist")
# Prefilter capacities small enough that rows go to the dense pass and
# some beyond it are dropped.
PREFILTER_CAPS = dict(prefilter_row_capacity=1, prefilter_dense_rows=4)
ENERGY_FIELDS = ("e_re", "e_im", "t_re", "t_im")


def _t(a):
    return torch.from_numpy(np.array(a))


def roundtrip(mesh):
    """``shard_rows`` / ``replicate`` on even and uneven row counts (with
    and without the whole count given), one ``all_to_all``, and
    ``hash_membership_dist`` on uneven row blocks."""
    out = {}
    for n in (12, 13):
        x = torch.arange(3 * n, dtype=torch.float32).reshape(n, 3)
        mask = torch.arange(n) % 3 == 0
        block, bmask = shard_rows((x, mask), mesh)
        out[f"block_{n}"] = block.numpy()
        out[f"whole_{n}"] = replicate(block, mesh).numpy()
        out[f"whole_total_{n}"] = replicate(block, mesh, n).numpy()
        out[f"mask_{n}"] = replicate(bmask, mesh).numpy()
    send = torch.arange(2 * mesh.size, dtype=torch.int64) + 100 * mesh.rank
    out["a2a"] = all_to_all(send, mesh).numpy()
    # 13 rows do not divide over D = 2 or 4: every rank raises.
    rows = shard_rows((torch.arange(13)[:, None], torch.zeros(13),
                       torch.zeros(13), torch.ones(13, dtype=torch.bool)),
                      mesh)
    try:
        hash_membership_dist(mesh, *rows, torch.tensor([[0], [1]]))
        out["uneven_raises"] = False
    except ValueError:
        out["uneven_raises"] = True
    return out


def membership(mesh, case):
    """``hash_membership_dist`` of this rank's rows of ``case``."""
    rows = shard_rows(tuple(_t(case[k]) for k in ("words", "la", "ph",
                                                  "valid")), mesh)
    la_p, ph_p, overflow = hash_membership_dist(
        mesh, *rows, _t(case["a_words"]), **case.get("kw", {}))
    return {"la_p": la_p.numpy(), "ph_p": ph_p.numpy(),
            "overflow": int(overflow)}


def engines(mesh, mol_path, case):
    """Every membership's local energies of this rank's rows of the set:
    {membership: fields}."""
    mol = Molecule.from_npz(mol_path)
    rows = shard_rows(tuple(_t(case[k]) for k in ("words", "la", "ph",
                                                  "valid")), mesh)
    out = {}
    for m in MESH_MEMBERSHIPS:
        caps = PREFILTER_CAPS if m == "prefilter" else {}
        eng = PauliEngine(mol.qubit_ham, device="cpu", membership=m,
                          mesh=mesh, **caps)
        e = eng.local_energy_proxy(*rows)
        out[m] = {f: getattr(e, f).numpy() for f in ENERGY_FIELDS}
        out[m].update(found_pairs=int(e.found_pairs),
                      table_overflow=int(e.table_overflow),
                      pf_dropped_rows=int(e.pf_dropped_rows))
    return out


def sampler_anqs(case):
    """JAX ``tests/test_parallel_sampler.py``'s ansatz with JAX's weights:
    ``n`` qubits at half filling and Sz 0, qubit_per_qudit 3, MADE
    ``width``."""
    n = case["n"]
    masker = Masker([particle_number_symmetry(n, n // 2),
                     spin_projection_symmetry(n, 0)])
    anqs = ANQS(QubitGrouping.create(masker, qubit_per_qudit=3),
                AnqsConfig(hidden_widths=(case["width"],)))
    anqs.load_state_dict(params_from_jax(case["params"]))
    return anqs


def sampler(mesh, case):
    """The Gumbel frontier sharded over the mesh (None: one process), from
    JAX's weights and uniforms."""
    anqs = sampler_anqs(case)
    uniforms = [_t(u) for u in case["uniforms"]]
    out = gumbel_top_k_sample(anqs, case["k"], uniforms=uniforms, mesh=mesh)
    return {f: getattr(out, f).numpy() for f in ("words", "log_probs",
                                                 "valid")}


def h2o_vmc(mesh, mol_path, membership, run_dir=None, **cfg):
    """JAX ``tests/test_dist_membership.py``'s trainer: H2O/STO-3G, 256
    Gumbel samples, qubit_per_qudit 3, Adam 2e-3, MADE 32, membership
    ``membership``."""
    mol = Molecule.from_npz(mol_path)
    config = VMCConfig(sample_num=256, sampling_mode="gumbel",
                       qubit_per_qudit=3, lr=2e-3,
                       engine_overrides={"membership": membership}, **cfg)
    return VMC(mol, config, AnqsConfig(hidden_widths=(32,)), device="cpu",
               run_dir=run_dir, mesh=mesh)


def step(mesh, mol_path, case):
    """One step of the H2O trainer on the mesh from JAX's weights and
    uniforms: its metrics."""
    vmc = h2o_vmc(mesh, mol_path, case["membership"])
    state = vmc.init_state()
    vmc.anqs.load_state_dict(params_from_jax(case["params"]))
    uniforms = [_t(u) for u in case["uniforms"]]
    return vmc.step(state, uniforms=uniforms)


def run_rows(path):
    with open(os.path.join(path, "result.csv")) as f:
        return [{k: float(v) for k, v in r.items()}
                for r in csv.DictReader(f)]


def run(mesh, mol_path, case):
    """``run()`` of the H2O trainer on the mesh into ``case['dir']``;
    rank 0 returns its ``result.csv`` rows."""
    vmc = h2o_vmc(mesh, mol_path, case["membership"], case["dir"])
    vmc.run(case["steps"], checkpoint_every=None, log_every=0)
    return run_rows(case["dir"]) if mesh.rank == 0 else None


def replicas(mesh, mol_path):
    """``VMC.check_replicas`` on equal parameters (it must pass), then with
    one entry one float32 ulp apart on the last rank: whether it raised."""
    vmc = h2o_vmc(mesh, mol_path, "hash")
    vmc.check_replicas()
    if mesh.rank == mesh.size - 1:
        with torch.no_grad():
            p = next(vmc.anqs.parameters()).view(-1)
            p[3] = torch.nextafter(p[3], torch.tensor(np.inf))
    try:
        vmc.check_replicas()
    except RuntimeError:
        return True
    return False


def escalation(mesh, case):
    """The colliding set's overflow at ``hash_extra_bits`` 0 and 1."""
    return {bits: membership(mesh, dict(case, kw={"hash_extra_bits": bits}))
            for bits in (0, 1)}


def single_and_mesh(mesh, mols_dir):
    """LiH through the dry run's legs: the sector path ('lih'), the tight
    routing slacks ('tight'); exact summation with the static partner
    tables and the full energy, multinomial sampling, and a distillation
    cycle, on the mesh against one process."""
    opts = {"mols_dir": mols_dir, "flagship": "proxy", "workdir": None}
    out = dryrun_multichip.run_legs(mesh, ("lih", "tight"), opts)
    for mode in ("exact", "multinomial", "cycle"):
        got = []
        for m in (None, mesh):
            vmc = dryrun_multichip.lih_vmc(mesh.device, m, mols_dir)
            if mode != "cycle":
                vmc = VMC(vmc.mol, vmc.config.replace(sampling_mode=mode),
                          vmc.anqs.config, device="cpu", mesh=m)
                got.append(vmc.step(vmc.init_state(),
                                    full_energy=mode == "exact"))
            else:
                vmc.config = vmc.config.replace(distill_steps=3)
                state = vmc.init_state()
                cyc = vmc.distill_cycle(state, vmc.make_distill_opt())
                got.append({k: float(v) for k, v in cyc.items()})
        out[mode] = got
    return out


def scenarios(mesh, inputs):
    """Every scenario of ``inputs`` on this rank: {name: result}."""
    out = {"roundtrip": roundtrip(mesh)}
    for name, case in inputs.get("membership", {}).items():
        out[f"membership/{name}"] = membership(mesh, case)
    mol_path = inputs["h2o_path"]
    if "engines" in inputs:
        out["engines"] = engines(mesh, mol_path, inputs["engines"])
    if "sampler" in inputs:
        out["sampler"] = sampler(mesh, inputs["sampler"])
    for name, case in inputs.get("steps", {}).items():
        out[f"step/{name}"] = step(mesh, mol_path, case)
    if "run" in inputs:
        out["run"] = run(mesh, mol_path, inputs["run"])
    if inputs.get("replicas"):
        out["replicas"] = replicas(mesh, mol_path)
    if "escalation" in inputs:
        out["escalation"] = escalation(mesh, inputs["escalation"])
    if "lih_dir" in inputs:
        out["lih"] = single_and_mesh(mesh, inputs["lih_dir"])
    return out
