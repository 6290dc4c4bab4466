"""The comparison's control on the CPU at a tiny size: the reference in
float8 put in the program's place, read at the served positions by the
token it puts first, against each tiny cell's limit.  At this size a run
judges some 60 tokens, so the control is held on three seeds together:
it fails the limits on most of them and reads several times the program
by one of the cell's numbers, and the program passes on each."""
from __future__ import annotations

import time

import pytest
import torch
from perfbench_tiny import one_thread, tiny_tree

from perfbench import check, manifest
from perfbench.run import run_cell


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    with one_thread():
        yield tiny_tree(tmp_path_factory.mktemp("perfbench"))


@pytest.mark.parametrize("cell", ["tiny-dense.tclosed", "tiny-moe.tclosed"])
def test_control_is_not_correct(tree, cell):
    limits = manifest.cell(tree, cell).limits
    names = [n for n in check.COMPARED if n in limits]
    program, control, failed = {}, {}, 0
    for seed in (1, 2, 3):
        r = run_cell(tree, cell, seed, 3.0, False, torch.device("cpu"),
                     time.perf_counter(), control=True)
        assert r["correct"], r["checks"]
        ok, ctl = check.verdict(check.control_readings(r["readings"]),
                                limits)
        failed += not ok
        for n in names:
            program[n] = program.get(n, 0.0) + r["checks"][n]["value"]
            control[n] = control.get(n, 0.0) + ctl[n]["value"]
    assert failed >= 2
    assert any(control[n] > 3 * program[n] for n in names), (program, control)
