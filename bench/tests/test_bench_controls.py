"""The control at a size a test run holds: the reference computed in
fp8, put in the program's place under a whole run of the cell, reads at
least three times what the program (bf16) reads on one number or more.
The limits are set for the cell's own size, from the readings that
``bench/tools/readings.py`` takes on the card there (PERF.md); its
``--execute-seeds`` and the card's tests show the control coming out as
not correct against them."""

import pytest

from bench import harness
from bench.tests.smoke import smoke_run
from bench.tools import planted


@pytest.mark.parametrize("workload", ["dsmoe.train.2x1024"])
def test_train_control_reads_far_above_the_program(workload):
    with planted.in_place("control"):
        low = harness.execute(smoke_run(workload))["checks"]
    got = harness.execute(smoke_run(workload))["checks"]
    assert any(low[k][0] >= 3 * got[k][0] for k in got), (got, low)


def test_limits_follow_the_rule():
    from bench.tools import limits

    def runs(**vals):
        return {str(i): dict(vals, loss1_rel=v, grad1_gap=v,
                             change3_diff_median=v)
                for i, v in enumerate(vals.pop("spread"))}

    readings = {
        "program": runs(spread=[0.01, 0.02], change3_gap=0.02,
                        grad1_diff_median=0.2),
        "control": runs(spread=[0.05], change3_gap=0.03,
                        grad1_diff_median=0.5),
        "half_batch": runs(spread=[0.05], change3_gap=0.05,
                           grad1_diff_median=0.9),
        "execute": {"frozen": {"9": {"numbers": dict(
            loss1_rel=0.0, grad1_gap=0.0, change3_diff_median=1.0,
            change3_gap=1.0, grad1_diff_median=0.2)}}}}
    lims, why = limits.limits(readings)
    # the control reads 2.5 x the lower: the upper of the difference;
    # the frozen state's 1 the change's and the change median's
    assert lims["grad1_diff_median"] == float(f"{0.2 ** (1 / 3) * 0.5 ** (2 / 3):.3g}")
    assert why["change3_gap"][2] == "frozen" and "loss1_rel" not in lims
    assert limits.caught(readings, lims) == {"control": [], "half_batch": [],
                                             "frozen": []}
