"""The port's profiler against the JAX package's.

``OpProfiler`` sections give the same stats and summary under a patched
clock, ``time_fn`` panics on NaN as the ProfilerConfig asks;
``check_numerics`` names the bad leaf with the JAX package's path
spelling; ``nan_panic`` raises at the backward op that makes a NaN and
restores anomaly mode after; ``DL4J_TORCH_NAN_PANIC`` makes the op
registry raise at the op whose output holds a NaN or Inf, as the JAX
registry's panic mode does; ``trace`` writes a Chrome trace.
"""

import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import profiler as jax_profiler
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.ops.registry import get_op
from deeplearning4j_tpu_torch.profiler import (
    OpProfiler, ProfilerConfig, check_numerics, nan_panic, trace,
)


def _clocked(monkeypatch, cls):
    ticks = itertools.count()
    monkeypatch.setattr("time.perf_counter",
                        lambda: 0.001 * (next(ticks) ** 1.5))
    prof = cls()
    for name, n in (("step", 7), ("data", 3), ("listeners", 1)):
        for _ in range(n):
            with prof.section(name):
                pass
    return prof


def test_op_profiler_stats_match_jax(monkeypatch):
    port = _clocked(monkeypatch, OpProfiler)
    ref = _clocked(monkeypatch, jax_profiler.OpProfiler)
    for name in ("step", "data", "listeners"):
        assert port.stats(name) == pytest.approx(ref.stats(name), rel=1e-12)
    assert port.summary() == ref.summary()
    assert dict(port.invocations) == dict(ref.invocations)
    assert port.stats("never") == {}
    port.reset()
    assert not port.times


def test_time_fn_returns_and_checks_numerics():
    prof = OpProfiler(ProfilerConfig(check_for_nan=True))
    out = prof.time_fn("mul", lambda a: a * 2, torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    assert prof.stats("mul")["count"] == 1
    with pytest.raises(FloatingPointError, match="NaN detected in div"):
        prof.time_fn("div", lambda a: a / 0 * 0, torch.ones(2))


@pytest.mark.parametrize("bad,inf", [("nan", True), ("inf", True),
                                     ("inf", False), (None, True)])
def test_check_numerics_names_the_leaf_as_jax_does(bad, inf):
    def tree(make, value):
        leaf = np.ones((2, 3), np.float32)
        if value is not None:
            leaf[1, 2] = value
        return [{"W": make(np.ones(3, np.float32)),
                 "b": make(np.arange(3))},
                {"fwd": {"R": make(leaf)}}]

    value = {"nan": np.nan, "inf": np.inf, None: None}[bad]
    outcomes = []
    for fn, make in ((check_numerics, torch.from_numpy),
                     (jax_profiler.check_numerics, jnp.asarray)):
        t = tree(make, value)
        try:
            fn(t, name="params", inf=inf)
            outcomes.append(None)
        except FloatingPointError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    if bad == "nan" or (bad == "inf" and inf):
        assert outcomes[0].endswith("in params at [1]['fwd']['R']")
    else:
        assert outcomes[0] is None


def test_nan_panic_raises_at_the_backward_op():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    before = torch.is_anomaly_enabled()
    with pytest.raises(RuntimeError, match="nan"):
        with nan_panic():
            assert torch.is_anomaly_enabled()
            torch.sqrt(x).sum().backward()  # d sqrt at 0 is inf; 0 * inf
            # the forward computed no NaN: the backward of the product
            (torch.sqrt(x) * 0).sum().backward()
    assert torch.is_anomaly_enabled() == before
    y = torch.tensor([1.0], requires_grad=True)
    with nan_panic():
        (y * 2).sum().backward()  # a clean backward passes
    assert y.grad.item() == 2.0


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_nan_panic_flag_raises_at_the_registry_op(monkeypatch, bad):
    import deeplearning4j_tpu_torch.ops.convolution  # noqa: F401 (registers)

    op = get_op("upsampling2d")
    x = torch.ones(1, 2, 2, 1)
    monkeypatch.setattr(env, "nan_panic", True)
    assert bool(torch.isfinite(op(x, size=(2, 2))).all())  # finite: passes
    x[0, 1, 1, 0] = bad
    with pytest.raises(FloatingPointError,
                       match="NaN/Inf in op upsampling2d"):
        op(x, size=(2, 2))
    monkeypatch.setattr(env, "nan_panic", False)
    assert not bool(torch.isfinite(op(x, size=(2, 2))).all())  # off: no check


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")) as prof:
        for _ in range(3):
            a = torch.mm(a, a).tanh()
    assert prof.trace_path == os.path.join(str(tmp_path / "prof"),
                                           "trace.json")
    doc = json.load(open(prof.trace_path))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any("mm" in str(n) for n in names)
