"""utils.profiling: trace capture + device-synced throughput meter (SURVEY.md
§6 tracing row — the reference has none; these are the rebuild's
instrumentation surfaces, used by the trainers' --profile-dir flag and the
epoch timing printouts)."""

import time

import jax.numpy as jnp

from iterative_inference_segm.utils import profiling


def test_sync_forces_completion():
    x = jnp.arange(8.0) * 2.0
    profiling.sync(x)  # must not raise on arrays or pytrees
    profiling.sync({"a": x, "b": x + 1})


def test_throughput_meter_rates():
    m = profiling.ThroughputMeter()
    x = jnp.ones((4, 4))
    m.start(sync_on=x)
    m.add(10)
    time.sleep(0.05)
    rate = m.stop(sync_on=x)
    assert 0 < rate < 10 / 0.05 + 1e-9  # at least the sleep elapsed

    m.reset()
    m.start()
    assert m.stop() == float("inf") or m.stop() >= 0  # zero items, no crash


def test_trace_writes_profile_artifacts(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        profiling.sync(jnp.ones((16, 16)) @ jnp.ones((16, 16)))
    files = [p for p in logdir.rglob("*") if p.is_file()]
    assert files, "jax.profiler trace produced no artifacts"


def test_trace_disabled_is_a_noop(tmp_path):
    logdir = tmp_path / "off"
    with profiling.trace(str(logdir), enabled=False):
        pass
    assert not logdir.exists()
