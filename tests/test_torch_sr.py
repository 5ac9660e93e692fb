"""MinSR of the PyTorch port against the JAX package.

The port solves the k x k system in float64, the JAX package by a
Schulz iteration in float32; on the same O-matrix and gradient the
preconditioned gradients agree to rtol 1e-4 (relative to their norm).
Per-sample Jacobians from the same weights agree to float32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from anqs_quantum_chemistry_tpu.optim import sr as jsr
from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.optim import sr
from torch_port_common import build_pair, to_np


def _rel_err(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("k", [25, 50])
# eps = 0 leaves only the relative floor 2^-20 * max diag S.
@pytest.mark.parametrize("eps", [1e-2, 1e-4, 0.0])
def test_minsr_precondition_matches_jax(k, eps):
    rng = np.random.default_rng(k)
    p = 400
    o = (rng.standard_normal((k, p)) + 1j * rng.standard_normal((k, p)))
    o = (0.3 * o).astype(np.complex64)
    g = rng.standard_normal(p).astype(np.float32)
    want = np.asarray(jsr.minsr_precondition(
        jnp.asarray(o.real), jnp.asarray(o.imag), jnp.asarray(g), eps,
    ))
    got = sr.minsr_precondition(
        torch.from_numpy(o.real.copy()), torch.from_numpy(o.imag.copy()),
        torch.from_numpy(g), eps,
    ).numpy()
    assert got.dtype == np.float32
    assert _rel_err(got, want) < 1e-4


def _lih_batch(rng, mol, rows=64):
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    return rng.choice(dets, rows, replace=False).astype(np.int64)[:, None]


def test_per_sample_jacobians_match_jax(rng):
    mol, jax_anqs, params, anqs = build_pair("LiH", 6, 32)
    words = _lih_batch(rng, mol, 16)
    unravel = ravel_pytree(params)[1]
    j_la_j, j_ph_j = jax.jit(
        lambda p, w: jsr._per_sample_jacobians(jax_anqs, p, w)[:2]
    )(params, jnp.asarray(words, jnp.uint32))
    want_la = params_from_jax(to_np(jax.vmap(unravel)(j_la_j)))
    want_ph = params_from_jax(to_np(jax.vmap(unravel)(j_ph_j)))
    params_t = dict(anqs.named_parameters())
    j_la, j_ph = sr._per_sample_jacobians(anqs, params_t,
                                          torch.from_numpy(words))
    off = 0
    for name, p in params_t.items():
        size = p.numel()
        for got, want in ((j_la, want_la), (j_ph, want_ph)):
            np.testing.assert_allclose(
                got[:, off:off + size].numpy(),
                want[name].reshape(len(words), -1).numpy(),
                rtol=1e-4, atol=1e-6, err_msg=name,
            )
        off += size
    assert off == j_la.shape[1]


def test_sr_transform_matches_jax(rng):
    mol, jax_anqs, params, anqs = build_pair("LiH", 6, 32)
    words = _lih_batch(rng, mol)
    weights = rng.random(len(words)).astype(np.float32)
    weights /= weights.sum()
    grads_j = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        params,
    )
    cfg_j = jsr.SRConfig(max_indices_num=50)
    want = jax.jit(
        lambda p, g, w, f: jsr.sr_transform(jax_anqs, p, g, w, f, cfg_j)
    )(params, grads_j, jnp.asarray(words, jnp.uint32), jnp.asarray(weights))
    params_t = dict(anqs.named_parameters())
    grads = params_from_jax(to_np(grads_j))
    grads = {n: grads[n] for n in params_t}
    got = sr.sr_transform(anqs, params_t, grads, torch.from_numpy(words),
                          torch.from_numpy(weights),
                          sr.SRConfig(max_indices_num=50))
    want_t = params_from_jax(to_np(want))
    flat_got = torch.cat([got[n].reshape(-1) for n in params_t]).numpy()
    flat_want = torch.cat([want_t[n].reshape(-1) for n in params_t]).numpy()
    assert _rel_err(flat_got, flat_want) < 1e-4
    assert ravel_pytree(want)[0].shape[0] == flat_got.shape[0]


def test_clip_grad_norm():
    grads = {"a": torch.tensor([3.0, 0.0]), "b": torch.tensor([[4.0]])}
    clipped, norm = sr.clip_grad_norm(grads, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert torch.allclose(clipped["a"], torch.tensor([0.6, 0.0]))
    same, _ = sr.clip_grad_norm(grads, 10.0)
    assert torch.equal(same["b"], grads["b"])
