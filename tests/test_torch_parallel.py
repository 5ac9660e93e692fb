"""The port's data-parallel path (``parallel/``, ``VMC(mesh=)``,
``gumbel_top_k_sample(mesh=)``) on gloo meshes of 2 and 4 CPU ranks,
against the JAX package's 8-virtual-device mesh code and single-device
runs, and against the port in one process.

The ranks are spawned processes (``experiments/dryrun_multichip.spawn``)
running ``torch_dist_common.scenarios``, which imports no JAX; each mesh
size is spawned once for the module, in a background thread, while the JAX
references are computed here. The cases:

(a) ``shard_rows`` / ``replicate`` round trips, even and uneven;
(b) ``hash_membership_dist`` at D = 4 against JAX's on ``make_mesh(4)``:
    H2O (W 1), the 40- and 70-qubit embeddings of JAX's
    ``test_dist_membership.py``, and H2O at ``query_slack=0.05``;
(c) every membership's local energies on the mesh, gathered, bit for bit
    the port's in one process, 'hash_dist' bit for bit 'hash';
(d) the sharded Gumbel frontier against JAX's replicated sampler (equal
    sets) and the port's in one process (bit for bit);
(e) a ``VMC(mesh=)`` step with 'hash_dist' and 'prefilter' against JAX's
    single-device step (1e-5 + 1e-4 |a|, the same pairs); LiH's sector,
    exact, full-energy and distillation paths against one process;
(f) ``run()`` for 3 steps at D = 2 against one process's rows;
(g) the ``hash_extra_bits`` escalation clearing a bucket overflow, which
    JAX's ``hash_dist`` cannot clear;
(h) the trainer's per-step replica check catching a one-ulp difference.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.chem.jw import jordan_wigner_pauli_hamiltonian
from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models import ANQS as JaxANQS
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.observables.pauli import (
    PauliEngine as JaxPauliEngine,
)
from anqs_quantum_chemistry_tpu.ops import bits as jbits
from anqs_quantum_chemistry_tpu.ops import keys as jkeys
from anqs_quantum_chemistry_tpu.parallel.dist_membership import (
    hash_membership_dist as jax_hash_membership_dist,
)
from anqs_quantum_chemistry_tpu.parallel.mesh import make_mesh as jax_mesh
from anqs_quantum_chemistry_tpu.sampling.sampler import (
    gumbel_top_k_sample as jax_gumbel_top_k_sample,
)
from anqs_quantum_chemistry_tpu.symmetries import Masker as JaxMasker
from anqs_quantum_chemistry_tpu.symmetries import (
    QubitGrouping as JaxGrouping,
)
from anqs_quantum_chemistry_tpu.symmetries import (
    particle_number_symmetry as jax_particle_number,
)
from anqs_quantum_chemistry_tpu.symmetries import (
    spin_projection_symmetry as jax_spin_projection,
)
from anqs_quantum_chemistry_torch.experiments.dryrun_multichip import spawn
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops import hash_lookup as hashops
from anqs_quantum_chemistry_torch.sampling.sampler import uniform_shapes
from torch_dist_common import (
    ENERGY_FIELDS,
    MESH_MEMBERSHIPS,
    PREFILTER_CAPS,
    h2o_vmc,
    run_rows,
    sampler as port_sampler_on,
    sampler_anqs,
    scenarios,
)
from torch_port_common import MOLS, jax_uniforms, molecules, mol_path, to_np

NEG = -1e30
MESH_SIZES = (2, 4)
STEP_TOL = (1e-5, 1e-4)  # JAX's tests/test_dist_membership.py
MEMBERSHIP_CASES = ("h2o", "emb40", "emb70", "h2o_tight")
SAMPLER = dict(n=12, width=16, k=256)


def _random_sorted_samples(rng, n, n_samp, active=None):
    """JAX ``tests/test_dist_membership.py``'s sample sets: sorted words
    with all-ones sentinels, ~90% valid and unique."""
    bits = np.zeros((n_samp, n), dtype=np.int64)
    for c in (active if active is not None else range(n)):
        bits[:, c] = rng.integers(0, 2, size=n_samp)
    words = jbits.pack(jnp.asarray(bits))
    valid = jnp.asarray(rng.random(n_samp) < 0.9)
    words = jnp.where(valid[:, None], words,
                      jnp.full_like(words, jbits.UINT(0xFFFFFFFF)))
    sw, _, sv = jkeys.sort_words(words, valid.astype(jnp.int32))
    sv = sv.astype(bool) & jkeys.unique_mask(sw)
    la = jnp.asarray(rng.standard_normal(n_samp), jnp.float32)
    ph = jnp.asarray(rng.standard_normal(n_samp), jnp.float32)
    return sw, la, ph, sv


def _embedded_ham(rng, n, act):
    h1 = np.zeros((n, n))
    sub = rng.standard_normal((len(act), len(act)))
    h1[np.ix_(act, act)] = sub + sub.T
    v = np.zeros((n,) * 4)
    s4 = rng.standard_normal((len(act),) * 4)
    v[np.ix_(act, act, act, act)] = s4 + s4.transpose(1, 0, 3, 2)
    return jordan_wigner_pauli_hamiltonian(h1, v)


def _case(sw, la, ph, sv, a_words, **kw):
    """A membership case as numpy (words and masks as int64)."""
    return {"words": np.asarray(sw).astype(np.int64),
            "la": np.asarray(la), "ph": np.asarray(ph),
            "valid": np.asarray(sv),
            "a_words": np.asarray(a_words).astype(np.int64), "kw": kw}


def _jax_args(case):
    return (jnp.asarray(case["words"].astype(np.uint32)),
            jnp.asarray(case["la"]), jnp.asarray(case["ph"]),
            jnp.asarray(case["valid"]))


def _colliding_set(rng, a_words):
    """64 H2O words: 40 in bucket 0 of 256 (20 each in buckets 0 and 256
    of 512), the rest elsewhere. At 32 entries a bucket, 8 overflow at the
    first sizing and none at one extra bit."""
    keys = torch.arange(1 << 14, dtype=torch.int64)
    h = hashops.bucket_hash([keys, torch.zeros_like(keys)]).numpy()
    low, high = (np.flatnonzero((h & 511) == b) for b in (0, 256))
    rest = np.flatnonzero((h & 255) != 0)
    words = np.concatenate([rng.choice(low, 20, replace=False),
                            rng.choice(high, 20, replace=False),
                            rng.choice(rest, 24, replace=False)])
    return _case(words[:, None], rng.standard_normal(64).astype(np.float32),
                 rng.standard_normal(64).astype(np.float32),
                 np.ones(64, bool), a_words)


@pytest.fixture(scope="module")
def refs():
    """The inputs both mesh sizes share, and what they need of JAX."""
    rng = np.random.default_rng(3)
    jmol, mol = molecules("H2O")
    a_h2o = JaxPauliEngine(jmol.qubit_ham, membership="hash").a_words
    cases = {"h2o": _case(*_random_sorted_samples(rng, jmol.qubit_num, 64),
                          a_h2o)}
    ham40 = _embedded_ham(rng, 40, list(range(12)))
    cases["emb40"] = _case(*_random_sorted_samples(
        rng, 40, 64, list(range(12)) + [35, 36, 37]),
        JaxPauliEngine(ham40, membership="hash").a_words)
    act = [0, 1, 30, 31, 32, 33, 62, 63, 64, 69]
    ham70 = _embedded_ham(rng, 70, act)
    assert ham70.a_masks.shape[1] == 3
    cases["emb70"] = _case(*_random_sorted_samples(rng, 70, 64, act),
                           JaxPauliEngine(ham70, membership="hash").a_words)
    cases["h2o_tight"] = dict(cases["h2o"], kw={"query_slack": 0.05})

    # (d): JAX tests/test_parallel_sampler.py's ansatz and key.
    n = SAMPLER["n"]
    jgrouping = JaxGrouping.create(JaxMasker(
        [jax_particle_number(n, n // 2), jax_spin_projection(n, 0)]), 3)
    janqs = JaxANQS(jgrouping, JaxAnqsConfig(
        hidden_widths=(SAMPLER["width"],)))
    sparams = janqs.init(jax.random.PRNGKey(2))
    skey = jax.random.PRNGKey(5)
    sampler_case = dict(SAMPLER, params=to_np(sparams))
    sampler_case["uniforms"] = [u.numpy() for u in jax_uniforms(
        skey, uniform_shapes(sampler_anqs(sampler_case), SAMPLER["k"]))]

    # (e): JAX's H2O trainers and their first step's uniforms.
    steps, jax_steps = {}, {}
    for m in ("hash_dist", "prefilter"):
        jv = jvmc.VMC(jmol, jvmc.VMCConfig(
            sample_num=256, sampling_mode="gumbel", qubit_per_qudit=3,
            lr=2e-3, engine_overrides={
                "membership": "hash" if m == "hash_dist" else m}),
            JaxAnqsConfig(hidden_widths=(32,)))
        p0, o0, key = jv.init_state()
        _, sample_key = jax.random.split(key)
        shapes = uniform_shapes(h2o_vmc(None, mol_path("H2O"), m).anqs, 256)
        steps[m] = {"membership": m, "params": to_np(p0),
                    "uniforms": [u.numpy() for u in jax_uniforms(
                        sample_key, shapes)]}
        jax_steps[m] = (jv, p0, o0, key)

    inputs = {"membership": cases, "h2o_path": mol_path("H2O"),
              "engines": cases["h2o"], "sampler": sampler_case,
              "steps": steps, "escalation": _colliding_set(rng, a_h2o),
              "replicas": True,
              "lih_dir": MOLS}
    return {"inputs": inputs, "janqs": janqs, "sparams": sparams,
            "skey": skey, "jax_steps": jax_steps, "jmol": jmol, "mol": mol}


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
    """{D: future of the D ranks' results}, spawned in the background."""
    pool = ThreadPoolExecutor(len(MESH_SIZES))
    futures = {}
    for d in MESH_SIZES:
        inputs = dict(refs["inputs"])
        if d == 4:
            inputs.pop("lih_dir")  # the LiH legs run at D = 2
        else:
            inputs["membership"] = {}  # JAX's references are at D = 4
            inputs["run"] = {"membership": "hash_dist", "steps": 3,
                                "dir": str(tmp_path_factory.mktemp("run2"))}
        futures[d] = pool.submit(spawn, scenarios, d, "gloo", "cpu",
                                 (inputs,), 300)
    yield futures
    pool.shutdown(wait=True)


def _gather(results, key):
    """The ranks' row blocks of ``results[r][key]`` joined in rank order
    (a dict of arrays is joined field by field)."""
    first = results[0][key]
    if isinstance(first, dict):
        return {f: _gather([{key: r[key][f]} for r in results], key)
                for f in first}
    if not isinstance(first, np.ndarray):
        return first  # a count, summed over the ranks already
    return np.concatenate([r[key] for r in results])


def test_bucket_of_shard_is_global_bucket_less_offset():
    """A query routed to owner ``bucket >> log2(nb_local)`` finds its row
    by kernel #2's own mask: ``bucket & (nb_local - 1)`` equals the global
    bucket less ``owner * nb_local`` (D = 8 at nb 256: nb_local 32)."""
    keys = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 32, size=(2, 4096), dtype=np.int64))
    h = hashops.bucket_hash([keys[0], keys[1]])
    for nb_total, d in ((256, 8), (1024, 4), (256, 2)):
        nb_local = nb_total // d
        bucket = h & (nb_total - 1)
        owner = bucket >> (nb_local.bit_length() - 1)
        assert bool(torch.all(owner < d))
        assert torch.equal(bucket - owner * nb_local, h & (nb_local - 1))


@pytest.mark.parametrize("d", MESH_SIZES)
def test_shard_rows_replicate_roundtrip(ranks, d):
    results = ranks[d].result()
    for n in (12, 13):
        x = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
        blocks = np.array_split(x, d)  # torch.tensor_split's cut
        for r, res in enumerate(results):
            got = res["roundtrip"]
            np.testing.assert_array_equal(got[f"block_{n}"], blocks[r])
            np.testing.assert_array_equal(got[f"whole_{n}"], x)
            np.testing.assert_array_equal(got[f"whole_total_{n}"], x)
            np.testing.assert_array_equal(got[f"mask_{n}"],
                                          np.arange(n) % 3 == 0)
    for r, res in enumerate(results):
        want = np.concatenate([np.arange(2 * r, 2 * r + 2) + 100 * s
                               for s in range(d)])
        np.testing.assert_array_equal(res["roundtrip"]["a2a"], want)
        assert res["roundtrip"]["uneven_raises"]  # JAX: assert b % d == 0


@pytest.mark.parametrize("name", MEMBERSHIP_CASES)
def test_hash_membership_dist_matches_jax(refs, ranks, name):
    """D = 4: la_p bit for bit, ph_p where found, the same overflow."""
    case = refs["inputs"]["membership"][name]
    mesh = jax_mesh(4)
    with mesh:
        jla, jph, jovf = jax.jit(functools.partial(
            jax_hash_membership_dist, mesh, "data", **case["kw"]))(
                *_jax_args(case), jnp.asarray(
                    case["a_words"].astype(np.uint32)))
    jla, jph = np.asarray(jla), np.asarray(jph)
    results = ranks[4].result()
    got = _gather(results, f"membership/{name}")
    np.testing.assert_array_equal(got["la_p"], jla)
    found = jla > 0.5 * NEG
    np.testing.assert_array_equal(got["ph_p"][found], jph[found])
    assert all(r[f"membership/{name}"]["overflow"] == int(jovf)
               for r in results)
    if name == "h2o_tight":
        assert int(jovf) > 0
    else:
        assert int(jovf) == 0 and found.any()


@pytest.mark.parametrize("d", MESH_SIZES)
def test_engine_memberships_on_mesh_match_one_process(refs, ranks, d):
    """Every membership's local energies of the ranks' rows, gathered,
    equal the port's in one process bit for bit (the prefilter at
    capacities that send rows to its dense pass and drop some), and
    'hash_dist' equals 'hash'."""
    case = refs["inputs"]["engines"]
    rows = tuple(torch.from_numpy(np.array(case[k]))
                 for k in ("words", "la", "ph", "valid"))
    got = _gather(ranks[d].result(), "engines")
    for m in MESH_MEMBERSHIPS:
        caps = PREFILTER_CAPS if m == "prefilter" else {}
        ref = PauliEngine(refs["mol"].qubit_ham, device="cpu", membership=(
            "hash" if m == "hash_dist" else m), **caps).local_energy_proxy(
                *rows)
        for f in ENERGY_FIELDS:
            np.testing.assert_array_equal(got[m][f], getattr(ref, f).numpy(),
                                          err_msg=f"{m} {f}")
        for f in ("found_pairs", "table_overflow", "pf_dropped_rows"):
            assert ranks[d].result()[0]["engines"][m][f] == int(
                getattr(ref, f)), (m, f)
    assert ranks[d].result()[0]["engines"]["prefilter"][
        "pf_dropped_rows"] > 0


@pytest.mark.parametrize("d", MESH_SIZES)
def test_sharded_frontier_matches_jax(refs, ranks, d):
    """The same set as JAX's replicated sampler (log-probs to 1e-5), and
    bit for bit the port's one-process frontier, on every rank."""
    js = jax.jit(lambda p, k: jax_gumbel_top_k_sample(
        refs["janqs"], p, k, SAMPLER["k"]))(refs["sparams"], refs["skey"])
    jvalid = np.asarray(js.valid)
    jw = np.asarray(js.words)[jvalid][:, 0].astype(np.int64)
    jl = np.asarray(js.log_probs)[jvalid]
    case = refs["inputs"]["sampler"]
    one = port_sampler_on(None, case)
    for res in ranks[d].result():
        got = res["sampler"]
        for f in ("words", "log_probs", "valid"):
            np.testing.assert_array_equal(got[f], one[f], err_msg=f)
        w = got["words"][got["valid"]][:, 0]
        lp = got["log_probs"][got["valid"]]
        np.testing.assert_array_equal(np.sort(w), np.sort(jw))
        np.testing.assert_allclose(lp[np.argsort(w)], jl[np.argsort(jw)],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", MESH_SIZES)
@pytest.mark.parametrize("membership", ["hash_dist", "prefilter"])
def test_vmc_mesh_step_matches_jax(refs, ranks, d, membership):
    """JAX's single-device step ('hash' for 'hash_dist') against the
    port's step on the mesh: every shared metric to 1e-5 + 1e-4 |a|, the
    same pairs; the ranks' metrics equal."""
    jv, p0, o0, key = refs["jax_steps"][membership]
    jm = {k: float(v) for k, v in jv._step(p0, o0, key)[3].items()}
    results = ranks[d].result()
    got = results[0][f"step/{membership}"]
    shared = sorted(set(jm) & set(got))
    assert {"energy", "energy_var", "found_pairs", "grad_norm",
            "hf_log_abs", "unique_num"} <= set(shared)
    for k in shared:
        a, b = jm[k], got[k]
        if np.isnan(a) and np.isnan(b):
            continue
        assert abs(a - b) <= STEP_TOL[0] + STEP_TOL[1] * abs(a), (k, a, b)
    assert got["found_pairs"] == jm["found_pairs"] > 0
    for r in results:  # every rank took the same step
        np.testing.assert_equal(r[f"step/{membership}"], got)


def test_lih_paths_on_mesh(ranks):
    """D = 2: LiH's sector step and the tight routing slacks (the dry
    run's legs assert them), the exact-summation step with the static
    tables and the full energy, a multinomial step, and a distillation
    cycle, against one process."""
    for res in ranks[2].result():
        lih = res["lih"]
        assert lih["lih"]["max_diff"] <= 1e-5
        assert lih["tight"]["table_overflow"] > 0
        for mode in ("exact", "multinomial", "cycle"):
            one, meshed = lih[mode]
            for k, a in one.items():
                b = meshed[k]
                assert abs(a - b) <= STEP_TOL[0] + STEP_TOL[1] * abs(a), (
                    mode, k, a, b)
        assert np.isfinite(lih["exact"][1]["full_energy"])


def test_run_on_mesh_matches_one_process(ranks, tmp_path):
    """D = 2: rank 0's ``result.csv`` of 3 steps against the rows of the
    same run in one process ('hash'), every column to 1e-5 + 1e-4 |a|."""
    h2o_vmc(None, mol_path("H2O"), "hash", str(tmp_path)).run(
        3, checkpoint_every=None, log_every=0)
    want = run_rows(str(tmp_path))
    results = ranks[2].result()
    got = results[0]["run"]
    assert results[1]["run"] is None  # rank 1 writes nothing
    assert len(got) == len(want) == 3
    for a_row, b_row in zip(want, got):
        for k, a in a_row.items():
            if k == "wall_time" or (np.isnan(a) and np.isnan(b_row[k])):
                continue
            assert abs(a - b_row[k]) <= STEP_TOL[0] + STEP_TOL[1] * abs(
                a), (k, a, b_row[k])


@pytest.mark.parametrize("d", MESH_SIZES)
def test_replica_check_catches_one_ulp(ranks, d):
    """The per-step replica check passes on equal parameters and raises on
    every rank when one entry on one rank is one float32 ulp off."""
    for res in ranks[d].result():
        assert res["replicas"]


@pytest.mark.parametrize("d", MESH_SIZES)
def test_extra_bits_clear_bucket_overflow(refs, ranks, d):
    """A bucket of 40 entries overflows by 8 at JAX's sizing, as JAX's
    'hash_dist' reports; one more bucket bit (the trainer's escalation)
    clears it in the port, while JAX's, which leaves ``hash_extra_bits``
    out of its sizing, still reports 8."""
    case = refs["inputs"]["escalation"]
    mesh = jax_mesh(4)
    jovf = []
    for bits in (0, 1):
        eng = JaxPauliEngine(refs["jmol"].qubit_ham, membership="hash_dist",
                             mesh=mesh, hash_extra_bits=bits)
        with mesh:
            out = jax.jit(eng.local_energy_proxy)(*_jax_args(case))
        jovf.append(int(out.table_overflow))
    assert jovf == [8, 8]
    for res in ranks[d].result():
        assert res["escalation"][0]["overflow"] == 8
        assert res["escalation"][1]["overflow"] == 0


def test_overflow_policy_escalates_hash_dist():
    """'escalate' under 'hash_dist' doubles both routing slacks and adds
    a bucket bit (JAX ``vmc.py:856-859``, with the bit honoured)."""
    v = h2o_vmc(None, mol_path("H2O"), "hash_dist")
    v._handle_overflow({"table_overflow": 3, "iter_idx": 0})
    eng = v.engine
    assert (eng.membership, eng.dist_entry_slack, eng.dist_query_slack,
            eng.hash_extra_bits) == ("hash_dist", 8.0, 3.0, 1)
