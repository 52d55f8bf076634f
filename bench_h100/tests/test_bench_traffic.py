"""The traffic generator: one plan a seed, the same work for every seed."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from traffic import ARRIVALS, _stratified, load_mix, plan, voices

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_plan_is_deterministic_for_a_seed(path):
    mix = load_mix(path)
    a, b = plan(mix, 2**31 + 12345, 30), plan(mix, 2**31 + 12345, 30)
    assert json.dumps(a) == json.dumps(b)
    assert plan(mix, 7, 30) != a


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_seed_does_the_same_work_in_the_same_order(path):
    mix = load_mix(path)
    p1, p2 = plan(mix, 1, 30), plan(mix, 2**31 + 5, 30)
    work = lambda p: [(r["due"], r["frames"], r["greedy"]) for r in p]  # noqa: E731
    assert work(p1) == work(p2)
    assert [r.get("text", r.get("texts")) for r in p1] != [r.get("text", r.get("texts"))
                                                           for r in p2]
    f = mix["frames"]
    assert all(f["min"] <= r["frames"] <= f["max"] for r in p1)
    if mix["arrivals"]["kind"] != "closed":
        assert len(p1) == round(mix["arrivals"]["rate_per_s"] * 30)
        assert p1[0]["due"] == 0.0 and p1[-1]["due"] < 30
        n = len(p1)  # stratified exponential gaps: their sum is the window, nearly
        assert np.diff([r["due"] for r in p1]).sum() == pytest.approx(
            n / mix["arrivals"]["rate_per_s"], rel=0.1)
        assert sorted(r["frames"] for r in p1) == sorted(_stratified(f, n))
    else:  # each cycle holds the stratified sizes once
        k = f["cycle"]
        assert Counter(r["frames"] for r in p1[:k]) == Counter(_stratified(f, k).tolist())


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_texts_voices_and_greedy_share(path):
    mix = load_mix(path)
    p = plan(mix, 99, 30)
    per = mix["text_tokens_per_frame"]
    for r in p:
        for t in r.get("texts", [r.get("text")]):
            assert len(t.encode()) == max(1, round(r["frames"] * per))
        assert 0 <= r["voice"] < mix["voices"]["count"]
    share = np.mean([r["greedy"] for r in p])
    assert abs(share - mix["greedy_share"]) < 0.05


def test_voices_are_seeded_waveforms():
    mix = load_mix(MIXES[0])
    a, b = voices(mix, 5), voices(mix, 5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    sr, v = mix["voices"]["sample_rate"], mix["voices"]
    lens = sorted(len(x) / sr for x in a)
    assert len(a) == v["count"] and lens[0] >= v["min_s"] - 1e-3 and lens[-1] <= v["max_s"]
    assert all(x.dtype == np.float32 and 0 < np.abs(x).max() <= 0.3 + 1e-6 for x in a)


@pytest.mark.parametrize("cv", [1.0, 2.0])
def test_gamma_arrivals_keep_the_rate_and_burst(cv):
    """Gamma gaps at a mix's mean rate: cv 1 is Poisson's spread, cv 2 bursts
    (many short gaps, a few long ones)."""
    mix = load_mix(MIXES[[p.stem for p in MIXES].index("serve16-poisson")])
    n, rate = 400, mix["arrivals"]["rate_per_s"]
    gaps = ARRIVALS["gamma"]({"rate_per_s": rate, "cv": cv}, n)
    assert gaps.mean() == pytest.approx(1 / rate, rel=0.05)
    assert gaps.std() / gaps.mean() == pytest.approx(cv, rel=0.15)
    if cv == 1.0:
        np.testing.assert_allclose(gaps, ARRIVALS["poisson"]({"rate_per_s": rate}, n),
                                   rtol=1e-6, atol=1e-9)
    m = dict(mix, arrivals={"kind": "gamma", "rate_per_s": rate, "cv": cv})
    assert json.dumps(plan(m, 3, 30)) == json.dumps(plan(m, 3, 30))


def test_unknown_arrivals_kind_raises():
    mix = load_mix(MIXES[0])
    with pytest.raises(ValueError, match="arrivals kind"):
        plan(dict(mix, arrivals={"kind": "sine", "rate_per_s": 1}), 1, 30)


CLOSED = [p for p in MIXES if load_mix(p)["arrivals"]["kind"] == "closed"]


@pytest.mark.parametrize("path", CLOSED, ids=lambda p: p.stem)
@pytest.mark.parametrize("speed", [0.7, 1.0, 1.3])
def test_a_closed_window_holds_whole_cycles(path, speed, monkeypatch):
    """Whatever the speed, a closed loop's window ends at a cycle's end (the
    first after its time), so it holds each size of the cycle equally often,
    and the rate over it does not hang on where the time ran out."""
    import drivers

    mix = load_mix(path)
    clock = [0.0]
    monkeypatch.setattr(drivers.time, "perf_counter", lambda: clock[0])

    class Loop(drivers.ClosedLoop):
        def __init__(self):
            self.mix = mix

        def _call(self, item, due):
            clock[0] += speed * (0.3 + item["frames"] / 100)
            return [{"frames": item["frames"], "due": due, "end": clock[0]}]

    p = plan(mix, 11, 30)
    recs = Loop().window(p, 0.0, 30.0)
    k = mix["frames"]["cycle"]
    assert len(recs) % k == 0 and len(recs) > k
    assert recs[-k]["due"] < 30.0 <= recs[-1]["end"]
    n = len(recs) // k
    assert Counter(r["frames"] for r in recs) == Counter(
        {f: c * n for f, c in Counter(_stratified(mix["frames"], k).tolist()).items()})
