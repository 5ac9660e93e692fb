"""The benchmark's plain transformer reference (``benchmark/reference/
transformer.py``, loaded by path) against the port's ``Transformer``-based
``ANQS.log_psi`` on the CPU: seeded ``transformer_init`` weights, with the
biases and layer-norm parameters moved off their initial values, at
d_model 16, 2 layers, 4 heads, d_ff 32; N2 at three qudit widths (a
narrower last qudit at 3 and 6) and C2H4/6-31G's two words at 4, with and
without the logit cap. log|psi| and phase agree to 1e-5 (float32 sums of a
few tens of terms). No JAX: the port and the reference alone."""

import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_torch.chem.fci import random_sector_dets
from anqs_quantum_chemistry_torch.chem.molecule import load_c2h4, load_n2
from anqs_quantum_chemistry_torch.experiments.preparation import create_masker
from anqs_quantum_chemistry_torch.models.anqs import ANQS, AnqsConfig
from anqs_quantum_chemistry_torch.ops import bits as bitops
from anqs_quantum_chemistry_torch.symmetries import QubitGrouping

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "reference")
TINY = dict(net_type="transformer", d_model=16, n_layers=2, n_heads=4,
            d_ff=32)
TOL = dict(rtol=1e-5, atol=1e-5)
MOLECULES = {"N2": load_n2, "C2H4": load_c2h4}


def _reference():
    """``benchmark/reference`` as the package ``bench_reference`` (its
    modules import each other relatively), then its ``transformer``."""
    name = "bench_reference"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REF_DIR, "__init__.py"),
            submodule_search_locations=[REF_DIR])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.transformer")


@pytest.fixture(scope="module")
def mols():
    return {}


def _mol(mols, name):
    if name not in mols:
        mols[name] = MOLECULES[name]()
    return mols[name]


def _port(mol, qpq, cap, seed):
    anqs = ANQS(QubitGrouping.create(create_masker(mol, "e_num_spin"), qpq),
                AnqsConfig(logit_cap=cap, **TINY),
                generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in anqs.named_parameters():
            if p.dim() == 1 and not name.endswith("start"):
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    return anqs


def _sector_words(mol, rows, seed):
    n = mol.qubit_num
    dets = random_sector_dets(n // 2, mol.n_alpha, mol.n_beta, rows,
                              np.random.default_rng(seed))
    bits = (dets[:, None] >> np.arange(n, dtype=np.uint64)) & np.uint64(1)
    return bitops.pack(torch.from_numpy(bits.astype(np.int64)))


@pytest.mark.parametrize("cap", [None, 4.0])
@pytest.mark.parametrize("name,qpq", [("N2", 3), ("N2", 4), ("N2", 6),
                                      ("C2H4", 4)])
def test_reference_matches_the_port(mols, name, qpq, cap):
    ref = _reference()
    mol = _mol(mols, name)
    anqs = _port(mol, qpq, cap, seed=7 + qpq)
    words = _sector_words(mol, 96, seed=qpq)
    net = ref.TransformerAnqs(mol.qubit_num, mol.n_alpha, mol.n_beta, qpq,
                              cap, TINY["n_heads"], TINY["n_layers"])
    params = {k: v.detach() for k, v in anqs.state_dict().items()}
    with torch.no_grad():
        la_p, ph_p = anqs.log_psi(words)
        la_r, ph_r = net.log_psi(params, bitops.unpack(
            words, mol.qubit_num).to(torch.int64))
    torch.testing.assert_close(la_r, la_p, **TOL)
    torch.testing.assert_close(ph_r, ph_p, **TOL)
    assert torch.isfinite(la_p).all() and float(la_p.max()) < 0.0


def test_reference_blocks_agree_with_one_pass(mols, monkeypatch):
    """Rows in blocks of the reference's ``ROW_BLOCK`` give what one block
    gives."""
    ref = _reference()
    mol = _mol(mols, "N2")
    anqs = _port(mol, 4, 4.0, seed=3)
    words = _sector_words(mol, 50, seed=1)
    bits = bitops.unpack(words, mol.qubit_num).to(torch.int64)
    net = ref.TransformerAnqs(mol.qubit_num, mol.n_alpha, mol.n_beta, 4, 4.0,
                              TINY["n_heads"], TINY["n_layers"])
    params = {k: v.detach() for k, v in anqs.state_dict().items()}
    whole = net.log_psi(params, bits)
    monkeypatch.setattr(ref, "ROW_BLOCK", 7)
    blocked = net.log_psi(params, bits)
    for a, b in zip(whole, blocked):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
