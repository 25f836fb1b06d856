"""On the card, at each cell's own size: the control (the program's int8
path, the nearest precision below the configurations' bfloat16) comes
out not correct, and a sound run of the same short window comes out
correct. Run on the card with ``python -m pytest --noconftest -m cuda
portbench/tests/test_control.py`` after ``cd`` to the repository root
(``--noconftest`` keeps the repository's own test configuration, which
imports JAX, out; this file sets its paths itself)."""
import os
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent), str(HERE.parent.parent)]

import harness  # noqa: E402
from readings import CONTROL  # noqa: E402

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in harness._json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(card, monkeypatch, name, control):
    for key in [k for k in os.environ if k.startswith("CHUNKFLOW_")]:
        monkeypatch.delenv(key)
    if control:
        for key, value in CONTROL.items():
            monkeypatch.setenv(key, value)
    result = harness.execute(harness.Cell(name), 3_300_000_007, 6.0, False)
    assert result["correct"] is not control, result["checked"]
