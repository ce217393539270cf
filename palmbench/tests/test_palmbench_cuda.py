"""On the card: the generator is the same from run to run, and one cell
runs end to end at its smoke sizes. Skips without a card."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from palmbench.gen import RowStream

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_generator_on_the_card_repeats(card):
    a = RowStream(3_000_000_029, "base", 256, card, 1 << 16).rows(0, 100_000)
    b = RowStream(3_000_000_029, "base", 256, card, 1 << 16).rows(50_000, 100_000)
    assert np.array_equal(a[50_000:], b)


@pytest.mark.cuda
def test_stream_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "palmbench/run.py", "--workload",
         "stream-seismic-btp-exact-b16", "--seed", "3000000031", "--seconds",
         "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"correct": true' in out.stdout.strip().splitlines()[-1]
