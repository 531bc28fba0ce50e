"""On the card: the control (the reference a precision lower: matrix
products in TF32, the spring-mass state kept in bfloat16; put in the
program's place) comes out not correct, while the program comes out
correct, at the cells' widths with 8 lanes and a 2 s window. Run with
``python -m pytest gpu_bench/tests -m card`` on a machine with a card."""

import pytest

from gpu_bench.harness import cell as cell_mod
from gpu_bench.harness import check, main
from gpu_bench.tests.tiny import args


@pytest.mark.card
@pytest.mark.parametrize("workload", ["rope.manipulate64", "pusht.push64"])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_fails_program_passes(card, workload, seed):
    cell = cell_mod.find(workload)
    cell.traffic["lanes"] = 8
    out = main.execute(args(workload, seed=seed, seconds=2.0, control=1),
                       cell, dev=card)
    assert out["correct"], out["compared"]
    ok, rows = check.verdict(dict(out["control"], start_gap=0.0),
                             cell.limits)
    assert not ok, rows
