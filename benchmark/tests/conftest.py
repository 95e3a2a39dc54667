"""Fixtures of the benchmark's CPU tests: a root of tiny configuration,
traffic and cell files made from the real ones, and the card check, which
is made inside a fixture, never while a module is imported.

Run them with `python -m pytest benchmark/tests -q` from the checkout's
root; the tests marked `card` run only where a CUDA card is present.
"""
from __future__ import annotations

import pytest
from bench_fixtures import make_tiny_root


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path):
    """(root, bench): tiny files under root and a BENCHMARK dict naming
    the cells tiny-bf16-clip, tiny-int8-clip, tiny-replay and tiny-streams."""
    return make_tiny_root(tmp_path)
