"""The readers of the program's own tracer on synthetic spans: the device
parts a step, the prompt median, the idle shares inside the host's spans
(each at most ``device_idle_share``), the captures before the window, and
None from a program without the tracer or with it off."""
import itertools

import pytest
import torch

import harness
from qwen3tts_tpu_torch.utils import timing

NS = 1_000_000_000
T0 = 100.0  # the window's start, perf_counter seconds


@pytest.fixture()
def tracer(monkeypatch):
    """A tracer in the program's place whose device clock reads 50 s when
    the host's reads 100 s, both at 1 s/s."""
    reads = itertools.count()

    def clock():
        k = next(reads)
        return T0 + k, (50 + k) * NS

    tr = timing.Tracer()
    tr.enable(clock=clock)
    monkeypatch.setattr(timing, "TRACE", tr)
    return tr


def span(tr, name, start, end, rid=None):
    tr.end(tr.begin(name, start, rid=rid), end)


def ctx(intervals=()):
    return {"t0": T0, "window_s": 10.0, "trace": {"intervals": list(intervals)}}


def read(name, c):
    return harness.load_reader(name)(c)


def _replay(tr, at_s, parts_us, n):
    """A replay whose steps start ``at_s`` seconds into the window, each
    step (predictor, talker, tail) microseconds long, ``n`` of them run."""
    base = (50 + at_s) * NS
    stamps = []
    for i, (p, t, tail) in enumerate(parts_us):
        s = base + i * 10_000_000
        stamps += [s, s + p * 1000, s + (p + t) * 1000, s + (p + t + tail) * 1000]
        if i >= n:
            stamps[-4:] = [0, 0, 0, 0]
    tr.device_replay(torch.tensor(stamps, dtype=torch.int64), torch.tensor(n),
                     steps=len(parts_us), codec=False)


def test_device_parts_a_step(tracer):
    _replay(tracer, 1.0, [(6000, 3000, 100), (6200, 3100, 100), (9999, 9999, 1)], n=2)
    _replay(tracer, -5.0, [(1, 1, 1)], n=1)  # before the window: left out
    c = ctx()
    assert read("predictor_ms_per_step", c) == pytest.approx(6.1)
    assert read("predictor_ms_per_step.b1", c) == pytest.approx(6.1)
    assert read("talker_ms_per_step", c) == pytest.approx(3.05)
    assert read("talker_ms_per_step.b1", c) == pytest.approx(3.05)


def test_prompt_median_by_request(tracer):
    for rid, (s, ms) in enumerate([(1.0, 40), (2.0, 10), (3.0, 25), (-1.0, 500)]):
        span(tracer, "prompt", T0 + s, T0 + s + ms / 1e3, rid=rid)
    span(tracer, "prompt", T0 + 4.0, T0 + 4.02, rid=2)  # a second span of request 2
    assert read("prompt_ms_p50.b1", ctx()) == pytest.approx(40.0)


def test_idle_shares_inside_the_hosts_spans(tracer):
    # decode 1-5 s, prompt 6-7 s into the window; the card busy 0-3 s and 6.5-10 s
    span(tracer, "decode", T0 + 1.0, T0 + 5.0)
    span(tracer, "prompt", T0 + 6.0, T0 + 7.0)
    c = ctx([(0.0, 3000.0), (6500.0, 10000.0)])
    assert read("idle_share_in_decode", c) == pytest.approx(20.0)
    assert read("idle_share_in_prompt", c) == pytest.approx(5.0)
    assert read("device_idle_share", c) == pytest.approx(35.0)


def test_captures_before_the_window(tracer):
    span(tracer, "capture", T0 - 20.0, T0 - 17.5)
    span(tracer, "capture", T0 - 3.0, T0 - 2.0)
    span(tracer, "capture", T0 + 1.0, T0 + 2.0)  # in the window: not set-up
    assert read("capture_s_in_setup", ctx()) == pytest.approx(3.5)


NEW = ["predictor_ms_per_step", "predictor_ms_per_step.b1", "talker_ms_per_step",
       "talker_ms_per_step.b1", "prompt_ms_p50.b1", "idle_share_in_decode",
       "idle_share_in_prompt", "capture_s_in_setup"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name, monkeypatch):
    off = timing.Tracer()
    monkeypatch.setattr(timing, "TRACE", off)
    assert read(name, ctx([(0.0, 1.0)])) is None  # the tracer off
    monkeypatch.delattr(timing, "TRACE")
    assert read(name, ctx([(0.0, 1.0)])) is None  # a program without one
