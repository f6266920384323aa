"""The 25-iteration north-star fixture (the bench gate's trajectory length,
bench.py:59-60) that chip_smoke.py's phase 4b holds the card to: it is the
5-iteration fixture's run carried on, and the helper that finds how long a
run stays inside the gate's bars reads it as documented.
"""

import json

import numpy as np
import pytest

import chip_smoke as cs


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_gate_fixture_continues_the_five_iteration_fixture():
    short, long = _load(cs.FIXTURE), _load(cs.FIXTURE_25)
    assert (short["iterations"], long["iterations"]) == (cs.ITERS, cs.GATE_ITERS)
    assert long["problem"] == short["problem"]
    assert long["converged_by"] == "max_iter"
    cfg = dict(long["train_config"], max_iter=cs.ITERS)
    assert cfg == short["train_config"]
    for key in ("z_trajectory", "cv_nlpd", "cv_solver", "total_nll"):
        assert len(long[key]) == cs.GATE_ITERS
        assert long[key][:cs.ITERS] == short[key]
    # the best CV score falls inside the first five iterations, so the
    # selected z and its test metrics are the short run's
    assert int(np.argmin(long["cv_nlpd"])) < cs.ITERS
    assert long["z_final"] == short["z_final"] and long["test_metrics"] == short["test_metrics"]
    assert 5 <= cs.GATE_HELD_ITERS <= cs.GATE_ITERS and cs.GATE_MARKS[-1] == cs.GATE_ITERS


@pytest.mark.parametrize("what,at,want_held", [
    (None, None, 25), ("z", 7, 7), ("cv", 11, 11), ("nan", 3, 3), ("z_inside", 4, 25)])
def test_gate_deviations_find_the_first_departure(what, at, want_held):
    ref = _load(cs.FIXTURE_25)
    z, cv = np.array(ref["z_trajectory"]), np.array(ref["cv_nlpd"])
    if what == "z":
        z[at, 13] += 2 * cs.Z_TOL
        z[at + 2:, 2] -= 1.0  # a later, larger departure does not hide the first
    elif what == "cv":
        cv[at] -= 2 * cs.NLPD_TOL
    elif what == "nan":
        z[at, 0] = np.nan
    elif what == "z_inside":
        z[at, 5] += 0.9 * cs.Z_TOL
    z_dev, cv_dev, held, first = cs.gate_deviations(z, cv, ref)
    assert z_dev.shape == cv_dev.shape == (25,) and held == want_held
    if what is None or what == "z_inside":
        assert first is None
    elif what == "z":
        assert first[:2] == (at + 1, "z[13]") and first[2] == pytest.approx(2 * cs.Z_TOL)
        assert z_dev[at + 2] == pytest.approx(1.0)
    elif what == "cv":
        assert first[:2] == (at + 1, "CV-NLPD") and first[2] == pytest.approx(2 * cs.NLPD_TOL)
    else:
        assert first[0] == at + 1 and first[1] == "z[0]"
    # a shorter run is held to the fixture's first iterations
    assert cs.gate_deviations(z[:2], cv[:2], ref)[2] == 2
