"""The port's profiling hooks (``tensorrl_qas_tpu_torch/utils/profiling.py``)
against the JAX package's ``utils/profiling.py``: ``PhaseTimer``'s summary
has the same keys and counts for the same phase sequence, and
``maybe_device_trace`` does nothing without ``TRLQAS_PROFILE`` and, with it
set to a directory on the CPU, writes a Chrome trace there that names an
operation run inside the region."""

import json

import torch

from tensorrl_qas_tpu.utils import profiling as jax_profiling
from tensorrl_qas_tpu_torch.utils import profiling

SEQUENCE = ("step", "replay", "step", "act", "step", "replay")


def _summary(timer_cls):
    timer = timer_cls()
    for name in SEQUENCE:
        with timer.phase(name):
            sum(range(100))
    return timer.summary()


def test_phase_timer_summary_matches_jax():
    ours, theirs = _summary(profiling.PhaseTimer), _summary(
        jax_profiling.PhaseTimer)
    assert list(ours) == list(theirs) == ["act", "replay", "step"]
    for name in ours:
        assert set(ours[name]) == set(theirs[name]) == {
            "total_s", "count", "mean_ms"}
        assert ours[name]["count"] == theirs[name]["count"]
    assert [ours[k]["count"] for k in ours] == [1, 2, 3]


def test_phase_timer_counts_a_phase_that_raises():
    timer = profiling.PhaseTimer()
    try:
        with timer.phase("fails"):
            raise RuntimeError
    except RuntimeError:
        pass
    assert timer.summary()["fails"]["count"] == 1


def test_device_trace_is_a_no_op_when_unset(tmp_path, monkeypatch):
    monkeypatch.delenv("TRLQAS_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_device_trace() as prof:
        torch.ones(4).sum()
    assert prof is None
    assert not any(tmp_path.iterdir())


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("TRLQAS_PROFILE", str(trace_dir))
    timer = profiling.PhaseTimer()
    with profiling.maybe_device_trace() as prof:
        with timer.phase("matmul phase"):
            a = torch.randn(32, 32)
            torch.mm(a, a)
    (path,) = trace_dir.iterdir()
    assert str(path) == prof.trace_path and path.suffix == ".json"
    names = {ev.get("name") for ev in json.loads(path.read_text())[
        "traceEvents"]}
    assert "aten::mm" in names
    assert "matmul phase" in names
    assert timer.summary()["matmul phase"]["count"] == 1
