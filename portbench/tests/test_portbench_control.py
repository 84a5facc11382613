"""The comparison that decides ``correct``, shown to fail: the control
(the reference in TF32 in the program's place) and every fault a cell can
have, planted under the timed path of a run on the CPU at a tiny size, are
judged not correct; the program as it is, correct."""

from __future__ import annotations

import pytest

from conftest import drive
from portbench import faults

CELLS = {"cli_dir1080_b8": "directory", "aspp_dir1080_b8": "directory", "cli_photo1080_b1": "photo",
         "cli_train640_b8": "train"}
SEED = 2_900_000_017


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_is_correct(cell):
    got = drive(cell, SEED)
    assert all(ok for _v, ok in got.values()), got


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    got = drive(cell, SEED, control=True)
    assert not all(ok for _v, ok in got.values()), got


@pytest.mark.parametrize("cell, fault", [(c, f) for c in sorted(CELLS) for f in sorted(faults.FAULTS[CELLS[c]])])
def test_fault_is_not_correct(cell, fault):
    got = drive(cell, SEED, fault=faults.FAULTS[CELLS[cell]][fault])
    assert not all(ok for _v, ok in got.values()), got


@pytest.mark.parametrize("cell, fault",
                         [(c, f) for c in sorted(CELLS) for f in sorted(faults.WINDOW_ONLY.get(CELLS[c], {}))])
def test_window_only_fault_is_not_correct(cell, fault):
    """A fault that starts with the window passes the first steps' numbers
    and fails the kept step's."""
    got = drive(cell, SEED, fault=faults.WINDOW_ONLY[CELLS[cell]][fault])
    assert all(ok for name, (_v, ok) in got.items() if not name.startswith("kept_")), got
    assert not all(ok for name, (_v, ok) in got.items() if name.startswith("kept_")), got
