"""``AnqsConfig.matmul_precision`` of the PyTorch port, on the CPU.

- None, 'default', 'float32' and 'highest' are strict float32: MADE, NADE
  and the transformer give outputs bit-identical to each other and to the
  plain float32 products that the nets computed before the field existed.
- At 'highest', a MADE, a NADE and a small transformer agree with the JAX
  package at 'highest' on the same weights: log|psi| and phase to 1e-6,
  relative and absolute (the transformer's phase, a sum of 13 qudits'
  outputs of magnitude up to 18 through layer norms and softmaxes, to
  1e-5 absolute: float32 summation order).
- 'bfloat16' rounds each operand to bfloat16 (round to nearest even) and
  sums in float32: MADE's raw output agrees with a numpy reference that
  does just that, to 1e-5 (summation order), and differs from float32's.
- Any other value raises ``ValueError`` naming it; ``VMC``'s
  ``config.json`` and checkpoints carry the field.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_torch.chem.fci import random_sector_dets
from anqs_quantum_chemistry_torch.chem.molecule import load_n2
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import ANQS, AnqsConfig
from anqs_quantum_chemistry_torch.models.made import made_masks
from anqs_quantum_chemistry_torch.models.precision import (
    PRECISIONS,
    check_precision,
)
from anqs_quantum_chemistry_torch.ops import bits as bitops
from torch_port_common import build_pair

FLOAT32_VALUES = (None, "default", "float32", "highest")
NETS = {
    "made": dict(hidden_widths=(64, 64), aux_hidden_widths=(32,)),
    "nade": dict(net_type="nade", hidden_widths=(32, 32),
                 aux_hidden_widths=(32,)),
    "transformer": dict(net_type="transformer", d_model=16, n_layers=2,
                        n_heads=2, d_ff=32, logit_cap=4.0),
}


def _words(mol, rows=64, seed=0):
    rng = np.random.default_rng(seed)
    dets = random_sector_dets(mol.qubit_num // 2, mol.n_alpha, mol.n_beta,
                              rows, rng)
    bits = (dets[:, None] >> np.arange(mol.qubit_num, dtype=np.uint64)) & 1
    return bitops.pack(torch.from_numpy(bits.astype(np.int64)))


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (round to nearest even) -> float32, on the bits."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("net", list(NETS))
def test_float32_values_are_bit_identical(net):
    """Every float32 spelling gives the same bits as None, for the raw
    outputs of both nets and for log|psi| and phase."""
    mol, _, params, anqs = build_pair("LiH", 4, **NETS[net])
    words = _words(mol)
    bits = bitops.unpack(words, mol.qubit_num, dtype=torch.float32)
    with torch.no_grad():
        base = [anqs.main(bits), anqs.aux(bits), *anqs.log_psi(words)]
    for prec in FLOAT32_VALUES[1:]:
        other = ANQS(anqs.grouping, AnqsConfig(**NETS[net],
                                               matmul_precision=prec))
        other.load_state_dict(anqs.state_dict())
        with torch.no_grad():
            got = [other.main(bits), other.aux(bits), *other.log_psi(words)]
        for a, b in zip(base, got):
            assert torch.equal(a, b), prec


def test_made_float32_is_the_plain_product():
    """MADE at None computes exactly the plain float32 products it computed
    before ``matmul_precision`` (``h @ (w * mask)``, tanh, residuals)."""
    mol, _, _, anqs = build_pair("LiH", 4, **NETS["made"])
    bits = bitops.unpack(_words(mol), mol.qubit_num, dtype=torch.float32)
    spec, p = anqs.main.spec, dict(anqs.main.named_parameters())
    masks = [torch.from_numpy(m) for m in made_masks(spec)]
    h = 1.0 - 2.0 * bits
    for i in range(2):
        z = torch.tanh(h @ (p[f"w{i}"] * masks[i]) + p[f"b{i}"])
        h = z + h if i > 0 and z.shape == h.shape else z
    want = (h @ (p["w2"] * masks[2]) + p["b2"]).reshape(
        bits.shape[0], spec.qudit_num, spec.max_qudit_dim, 1)
    with torch.no_grad():
        assert torch.equal(anqs.main(bits), want)


@pytest.mark.parametrize("net", list(NETS))
def test_highest_matches_jax_highest(net):
    """The same weights at 'highest' in both packages: log|psi| and phase
    to 1e-6 (the transformer: 1e-5 absolute)."""
    mol, jax_anqs, params, anqs = build_pair(
        "LiH", 4, matmul_precision="highest", **NETS[net])
    words = _words(mol)
    jla, jph = jax_anqs.log_psi(params, jnp.asarray(words.numpy(),
                                                    jnp.uint32))
    with torch.no_grad():
        la, ph = anqs.log_psi(words)
    atol = 1e-5 if net == "transformer" else 1e-6
    np.testing.assert_allclose(la.numpy(), np.asarray(jla), rtol=1e-6,
                               atol=atol)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jph), rtol=1e-6,
                               atol=atol)


def test_bfloat16_rounds_each_operand():
    """MADE's main net at 'bfloat16' against numpy with each matmul operand
    rounded to bfloat16 and float32 sums: 1e-5; float32 differs by more."""
    mol, _, _, anqs = build_pair("LiH", 4, matmul_precision="bfloat16",
                                 **NETS["made"])
    bits = bitops.unpack(_words(mol), mol.qubit_num, dtype=torch.float32)
    spec = anqs.main.spec
    p = {k: v.detach().numpy() for k, v in anqs.main.named_parameters()}
    masks = made_masks(spec)
    h = 1.0 - 2.0 * bits.numpy()
    for i in range(2):
        z = np.tanh(_bf16(h) @ _bf16(p[f"w{i}"] * masks[i]) + p[f"b{i}"])
        h = z + h if i > 0 and z.shape == h.shape else z
    want = _bf16(h) @ _bf16(p["w2"] * masks[2]) + p["b2"]
    with torch.no_grad():
        got = anqs.main(bits).reshape(want.shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    f32 = ANQS(anqs.grouping, AnqsConfig(**NETS["made"]))
    f32.load_state_dict(anqs.state_dict())
    with torch.no_grad():
        plain = f32.main(bits).reshape(want.shape).numpy()
    assert np.max(np.abs(plain - want)) > 1e-4


def test_bf16_reference_rounds_to_nearest_even():
    """The numpy reference equals torch's own float32 -> bfloat16 cast."""
    x = np.random.default_rng(1).normal(size=4096).astype(np.float32)
    x[:3] = [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0]  # ties, sign
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(_bf16(x), want)


@pytest.mark.parametrize("bad", ["tf32", "bf16", "HIGHEST", 3])
def test_unknown_precision_raises(bad):
    with pytest.raises(ValueError, match=repr(bad)):
        AnqsConfig(matmul_precision=bad)
    with pytest.raises(ValueError, match="matmul_precision"):
        check_precision(bad)
    assert set(FLOAT32_VALUES) < set(PRECISIONS)


def test_precision_in_config_json_and_checkpoint(tmp_path):
    run_dir = str(tmp_path / "run")
    vmc = VMC(load_n2(), VMCConfig(sample_num=16, qubit_per_qudit=10),
              AnqsConfig(matmul_precision="bfloat16"), device="cpu",
              run_dir=run_dir)
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["anqs"]["matmul_precision"] == "bfloat16"
    assert cfg["sample_num"] == 16
    state = vmc.init_state()
    vmc.save_checkpoint(os.path.join(run_dir, "ckpt_0"), state, 0)
    ckpt = torch.load(os.path.join(run_dir, "ckpt_0", "checkpoint.pt"),
                      weights_only=True)
    assert ckpt["anqs_config"]["matmul_precision"] == "bfloat16"
    vmc.load_checkpoint(os.path.join(run_dir, "ckpt_0"))
