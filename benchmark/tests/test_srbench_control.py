"""The control must come out not correct: the reference one precision lower
(``reference/control.py``) in the program's place, at the cell's own size,
judged by the cell's own limits. On the card only:

    python -m pytest benchmark/tests/test_srbench_control.py -q -m cuda
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import cell as cells  # noqa: E402



@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["sd15-stream-512", "sdxl-1024-seq"])
def test_the_control_is_not_correct(card, cell_name):
    from benchmark.reference.control import control_checks

    cell = cells.load_cell(cell_name, ROOT)
    stream = bool(cell.traffic["render"].get("stream"))
    window = [10, 11] if stream else [3, 4]
    got = control_checks(cell.config, cell.traffic, 3100000007, card, window)
    judged = cells.judge(got, cell.limits)
    assert not cells.correct_of(judged), judged
