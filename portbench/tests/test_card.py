"""On a card only (marker ``cuda``; they skip elsewhere, decided in a
fixture): the controls at the cells' own sizes (they run no program, and
take seconds), the reference in TF32 in the program's place, must come out
not correct on three seeds; and a tiny run of each cell
on the card must come out correct.

    python3 -m pytest portbench/tests/test_card.py -p no:cacheprovider
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


CELLS = ["rnase_dodec.align_within", "apoa1_92k.sasa", "apoa1_92k.align_within"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(full_bench, card, cell):
    from portbench import control

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = control.main(["--workload", cell, "--seeds", "11,12,13"], bench=full_bench,
                          device=card)
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert rc == 0 and len(lines) == 3 and not any(x["correct"] for x in lines)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_on_the_card_is_correct(tiny_bench, card, cell):
    from portbench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", cell, "--seed", "21", "--seconds", "1", "--trace", "1"],
                      bench=tiny_bench)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
