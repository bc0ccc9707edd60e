"""The comparison that decides ``correct`` fails what it must: the
lower-precision control (the reference one precision down, in the
program's place), and each fault a cell can have, planted under the
timed path of a whole rehearsal."""
import re

import pytest

from helpers import rehearse

CONTROL = re.compile(r"^control check (\S+) = (\S+) \(limit (\S+)\) "
                     r"(ok|FAILED)$", re.M)


@pytest.mark.parametrize("cell", ["icu-analyst"])
def test_control_fails_and_program_passes(cell):
    rc, result, err = rehearse(cell, 424242, 1.0, "--control", "1")
    assert rc == 0, err[-2000:]
    assert result["correct"] is True
    verdicts = CONTROL.findall(err)
    assert verdicts and any(v[3] == "FAILED" for v in verdicts)


@pytest.mark.parametrize("cell,fault", [
    ("icu-analyst", "stale"),      # a step returns its state unchanged
    ("icu-analyst", "half_rows"),  # half of the batch left out
    ("icu-analyst", "quant"),      # an answer altered where produced
])
def test_fault_makes_the_run_incorrect(cell, fault):
    rc, result, err = rehearse(cell, 77, 1.0, fault=fault)
    assert rc == 0, err[-2000:]
    assert result["correct"] is False
