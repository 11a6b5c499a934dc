"""Fixtures of the harness's own tests, imported by the test modules
(``python3 -m pytest hvdbench/tests -p hvdbench.tests.fixtures``; the
plugin option registers the ``gpu`` marker, which ``-m gpu`` selects on
the card)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from hvdbench import cells
from hvdbench.tests import tiny

REPO = cells.ROOT


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny.make_root(tmp_path_factory.mktemp("hvdbench"))


def run_in(root: Path, args,
           timeout: float = 600) -> subprocess.CompletedProcess:
    """``python <args>`` in the checkout ``root`` (its ``hvdbench`` first on
    the path, the port after it), on the CPU with few threads."""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(root), str(REPO)]))
    return subprocess.run([sys.executable, *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
