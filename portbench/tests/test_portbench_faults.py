"""The comparison rejects a run whose timed path is broken underneath:
each fault the cell can have, planted under the loop's call, makes
``correct`` false.  (The exchange between chips has no fault to plant: every
cell runs on one card.)"""

import pytest

from portbench.tests.conftest import run_tiny

FAULTS = [("rn", "half_batch"), ("vit", "answer_altered"), ("rn", "answer_altered"),
          ("vit", "half_batch"), ("wb", "state_unchanged"), ("wb", "half_batch"),
          ("ca", "state_unchanged"), ("ca", "half_batch")]


@pytest.mark.parametrize("kind,fault", FAULTS)
def test_fault_is_rejected(kind, fault):
    out = run_tiny(kind, faults=(fault,))
    assert not out.correct, [(c.name, c.value, c.limit) for c in out.checks]


def test_state_unchanged_reads_one():
    found = {c.name: c.value for c in run_tiny("wb", faults=("state_unchanged",)).checks}
    assert found["change_gap"] == pytest.approx(1.0)
