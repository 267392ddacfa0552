"""The arithmetic that the end-to-end bounds are set from (``sets.py``)."""

import json
import statistics

import pytest

from benchmark import sets


def test_spread_is_the_interquartile_range_over_the_median():
    values = [100.0, 102.0, 98.0, 101.0, 99.0, 103.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert sets.spread(values) == pytest.approx((q3 - q1) / med)


def test_the_farthest_run_is_left_out_for_tightness():
    values = [100.0, 101.0, 99.0, 100.5, 99.5, 140.0]
    assert sets.spread_without_farthest(values) == pytest.approx(
        sets.spread([100.0, 101.0, 99.0, 100.5, 99.5]))
    assert sets.spread_without_farthest(values) < sets.spread(values)


@pytest.mark.parametrize("widest,bound", [(0.0001, 0.01), (0.01, 0.05), (0.08, 0.25)])
def test_the_bound_is_five_spreads_between_one_and_twenty_five_percent(widest, bound):
    assert sets.suggested_bound(widest) == pytest.approx(bound)


def test_summarize_reads_the_runs_of_each_set(tmp_path):
    def line(v, correct=True):
        return {"correct": correct, "attempted": 1, "failed": 0,
                "metrics": {"rate": {"value": v, "unit": "x/s"}},
                "device": {"memory_peak_bytes": 7},
                "checks": {"gap": {"value": v / 1e4, "limit": 1.0}}}

    a = [100.0, 101.0, 99.0, 100.5, 99.5, 100.2]
    b = [100.4, 100.9, 98.0, 101.5, 99.1, 100.0]
    for name, vals in (("A", a), ("B", b)):
        for i, v in enumerate(vals, 1):
            (tmp_path / f"{name}{i}-{10 + i}.out").write_text(
                json.dumps({"counters": {}}) + "\n" + json.dumps(line(v)) + "\n")
    (tmp_path / "T1-99-trace.out").write_text(json.dumps(line(5.0, False)) + "\n")
    s = sets.summarize([str(tmp_path)])
    assert (s["runs"], s["correct"], s["seeds"]) == (13, 12, list(range(11, 17)) + [99])
    m = s["metrics"]["rate"]
    assert m["sets"]["A"]["values"] == a and m["sets"]["B"]["values"] == b
    assert m["widest_spread"] == pytest.approx(max(sets.spread(a), sets.spread(b)))
    assert m["bound"] == sets.suggested_bound(m["widest_spread"])
    assert m["pooled_spread"] == pytest.approx(sets.spread(a + b))
    assert s["checks"]["gap"]["max"] == pytest.approx(101.5 / 1e4)
    assert len(s["traced"]) == 1
