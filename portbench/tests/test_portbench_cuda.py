"""One short run of a cell on the card, through the benchmark's command."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_product_nfm16_runs_correct_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "product-nfm16",
                          "--seed", str(2**31 + 11), "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "check"


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "product-nfm16",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
