"""The frozen upstream answers equal the repository's CPU oracles, and the
comparison's numbers on hand-made answers."""
import json
import os

import numpy as np
import pytest

from bench_port import core
from bench_port.reference import compare, freeze, upstream


@pytest.mark.parametrize("name", sorted(freeze.POOLS))
def test_frozen_answers_equal_the_oracles(name):
    meta = freeze.POOLS[name]
    with open(os.path.join(core.ROOT, meta["oracle"])) as f:
        per_seed = json.load(f)["per_seed"]
    pool = upstream.pool(name)
    assert sorted(pool.ids) == sorted(int(k) for k in per_seed)
    assert (pool.rate, pool.post_rate, pool.minutes) == (meta["rate"], 302, 10.0)
    for rid in pool.ids:
        want, got = per_seed[str(rid)], pool.answer(rid)
        assert np.array_equal(got["positions"] / pool.post_rate, want["beat_times"])
        assert np.array_equal(got["bpm_times"], want["bpm_times"])
        assert np.array_equal(got["bpm"], want["bpm_values"])


def _answer(pos, times, bpm):
    return {"positions": np.asarray(pos, np.int64), "bpm_times": np.asarray(times, float),
            "bpm": np.asarray(bpm, float)}


def test_numbers_on_hand_made_answers():
    ref = _answer([10, 20, 30, 40], [1.0, 2.0, 3.0], [60.0, 62.0, 64.0])
    same = compare.numbers(ref, ref)
    assert same == {"beats_moved_pct": 0.0, "bpm_mae": 0.0}
    got = _answer([10, 21, 30, 40], [1.0, 3.0], [61.0, 65.0])
    n = compare.numbers(dict(got, csv=(np.array([1.0, 2.0, 3.0]), np.array([60.0, 62.5, 64.0]))),
                        ref)
    assert n["beats_moved_pct"] == pytest.approx(50.0)
    assert n["bpm_mae"] == pytest.approx((1.0 + 1.0 + 1.0) / 3)
    assert n["csv_mae"] == pytest.approx(0.5 / 3)
    assert compare.worst([same, n])["bpm_mae"] == n["bpm_mae"]


def test_nan_on_one_side_is_an_infinite_gap():
    ref = _answer([1], [1.0, 2.0], [60.0, np.nan])
    assert compare.numbers(_answer([1], [1.0, 2.0], [60.0, np.nan]), ref)["bpm_mae"] == 0.0
    assert compare.numbers(_answer([1], [1.0, 2.0], [60.0, 61.0]), ref)["bpm_mae"] == np.inf
    assert compare.numbers(_answer([1], [], []), ref)["bpm_mae"] == np.inf


def test_csv_reads_back(tmp_path):
    p = tmp_path / "x_bpm_plot.csv"
    p.write_text("Time (s),BPM\n1.000,60.125\n2.500,61.000\n")
    t, b = compare.read_csv(str(p))
    assert t.tolist() == [1.0, 2.5] and b.tolist() == [60.125, 61.0]
