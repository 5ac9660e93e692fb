"""The benchmark's CPU tests: the harness's folder and the repository's
root on the path, the test-only tiny manifest, and a fixture that skips a
test without a CUDA card."""

import os
import sys

import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(TESTS_DIR)
REPO_DIR = os.path.dirname(BENCH_DIR)
TINY_DIR = os.path.join(TESTS_DIR, "tiny")
for path in (REPO_DIR, BENCH_DIR, TESTS_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def tiny():
    from benchlib.manifest import Manifest

    return Manifest(os.path.join(TINY_DIR, "manifest.json"),
                    os.path.join(TINY_DIR, "workloads"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the machine with the card)")
    return torch.device("cuda")
