"""The port's fault plans and training checkpoints against the JAX package.

``deeplearning4j_tpu_torch.faults`` is a copy of the JAX package's
framework-free module: the same spec gives the same rules, the same spec
and seed fire at the same calls, and ``poison_batch`` writes the same
bytes. ``util/checkpoints.py`` writes the port's own step directories
(orbax is not on the card's machine) under the JAX package's durability
contract: a manifest of per-leaf crc32s (the same numbers for the same
weights as the JAX package's manifest), ``CheckpointCorrupt`` on a
mismatch, newest-valid fallback, retention that keeps the last known-good
step, I/O under ``RetryPolicy``, and the ``ckpt_io`` / ``ckpt_corrupt`` /
``data_io`` fault points. Ported from tests/test_faults.py and
tests/test_profiler_checkpoints.py.
"""

import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import faults as jax_faults
from deeplearning4j_tpu.nn import (
    InputType as JaxInputType, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.layers import (
    BatchNormalizationLayer as JaxBN, DenseLayer as JaxDense,
    OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.optimize import Adam as JaxAdam
from deeplearning4j_tpu.util import checkpoints as jax_ckpt
from deeplearning4j_tpu_torch import faults
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.faults import (
    CheckpointIOFault, DataReadFault, RetryPolicy, parse_spec,
)
from deeplearning4j_tpu_torch.faults.retry import RetryDeadlineExceeded
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.util.checkpoints import (
    AsyncCheckpointListener, CheckpointCorrupt, TrainingCheckpointer,
    checksum, flatten,
)


@pytest.fixture(autouse=True)
def _isolate():
    """No fault plan around any test, in either package."""
    faults.configure("")
    jax_faults.configure("")
    yield
    faults.configure("")
    jax_faults.configure("")


def _jax_conf(seed=5):
    return (JaxNNC.builder().seed(seed).updater(JaxAdam(lr=1e-2)).list()
            .layer(JaxDense(n_out=6, activation="relu"))
            .layer(JaxBN())
            .layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())


def _model(seed=5):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jax_conf(seed).to_json())).init(device="cpu")


def _data(n=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _ckpt(tmp_path, **kw):
    kw.setdefault("async_save", False)
    kw.setdefault("retry", RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                       seed=0))
    return TrainingCheckpointer(tmp_path / "ck", **kw)


def _rules(rules):
    return [(r.cls, r.rate, r.var, r.op, r.value) for r in rules]


# --------------------------------------------------------------- grammar
SPECS = ["ckpt_io:0.3;collective_delay:2@step>10;worker_crash:1@round==3",
         "nan_grad:1@step>20;loss_spike:0.5;data_corrupt:1@step==3",
         "data_io:99@call>=3", " ckpt_corrupt:2 ; ; preempt:1@step!=4 "]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_as_jax(spec):
    assert _rules(parse_spec(spec)) == _rules(jax_faults.parse_spec(spec))


@pytest.mark.parametrize("bad", ["nope:1", "ckpt_io", "ckpt_io:x",
                                 "ckpt_io:0", "ckpt_io:1@stepfive",
                                 "ckpt_io:1@step==x"])
def test_malformed_specs_fail_loud_as_jax(bad):
    with pytest.raises(ValueError):
        jax_faults.parse_spec(bad)
    with pytest.raises(ValueError):
        parse_spec(bad)


@pytest.mark.parametrize("spec,seed", [("ckpt_io:0.5", 7), ("ckpt_io:0.5", 8),
                                       ("data_io:2", 0),
                                       ("data_io:0.3@call>=3", 4)])
def test_seeded_firing_matches_jax(spec, seed):
    def draws(mod):
        with mod.injected(spec, seed=seed) as plan:
            return [plan.fires(spec.split(":")[0]) for _ in range(40)]

    assert draws(faults) == draws(jax_faults)


def test_predicate_gates_on_context_and_env_round_trip(monkeypatch):
    with faults.injected("worker_crash:1@round==3") as plan:
        assert [plan.fires("worker_crash", round=r) for r in range(6)] == [
            False, False, False, True, False, False]
    monkeypatch.setenv(faults.ENV_SPEC, "infer_crash:1")
    monkeypatch.setenv(faults.ENV_SEED, "11")
    assert faults.ENV_SPEC == "DL4J_TORCH_FAULTS"
    faults.reset()
    plan = faults.active()
    assert plan is not None and plan.seed == 11
    assert [r.cls for r in plan.rules] == ["infer_crash"]
    monkeypatch.delenv(faults.ENV_SPEC)
    faults.reset()
    assert faults.active() is None


@pytest.mark.parametrize("cls", ["nan_grad", "loss_spike", "data_corrupt"])
def test_poison_batch_bytes_match_jax(cls):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    spec = f"{cls}:1@step==7"
    with faults.injected(spec) as plan, jax_faults.injected(spec) as jplan:
        assert faults.poison_batch(plan, x, y, step=6)[0] is x
        px, py = faults.poison_batch(plan, x, y, step=7)
        jx, jy = jax_faults.poison_batch(jplan, x, y, step=7)
    assert px.tobytes() == np.asarray(jx).tobytes()
    assert py is y and not np.isnan(x).any()
    tokens = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert faults._poison_features(tokens, cls) is tokens
    out = faults._poison_features([tokens, x, y], cls)
    assert out[0] is tokens and out[2] is y


# ---------------------------------------------------------------- retry
def test_retry_policy_delays_and_outcomes_match_jax():
    a = RetryPolicy(max_attempts=6, base_delay_s=0.1, max_delay_s=0.5,
                    jitter=0.5, seed=3)
    b = jax_faults.RetryPolicy(max_attempts=6, base_delay_s=0.1,
                               max_delay_s=0.5, jitter=0.5, seed=3)
    assert [a.delay_for(i) for i in range(1, 7)] == [
        b.delay_for(i) for i in range(1, 7)]
    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    p = RetryPolicy(max_attempts=4, base_delay_s=0.01, seed=0,
                    sleep=slept.append)
    assert p.call(flaky, component="t") == "ok" and len(slept) == 2
    with pytest.raises(ValueError):  # not retryable: no retry
        p.call(lambda: (_ for _ in ()).throw(ValueError("x")))
    with pytest.raises(OSError):
        RetryPolicy(max_attempts=2, base_delay_s=0.001).call(
            lambda: (_ for _ in ()).throw(OSError("x")))
    with pytest.raises(RetryDeadlineExceeded):
        RetryPolicy(max_attempts=50, base_delay_s=0.05, deadline_s=0.01,
                    sleep=lambda s: None).call(
            lambda: (_ for _ in ()).throw(OSError("x")))


# -------------------------------------------------------- data read faults
def test_iterator_read_retry_preserves_stream_and_gives_up():
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    y = np.eye(2, dtype=np.float32)[np.arange(16) % 2]
    it = ArrayDataSetIterator(x, y, batch_size=4)
    it._retry = RetryPolicy(max_attempts=4, base_delay_s=0.001)
    with faults.injected("data_io:2") as plan:
        batches = list(it)
    assert plan.injected["data_io"] == 2 and len(batches) == 4
    np.testing.assert_array_equal(
        np.concatenate([b.features for b in batches]), x)
    it._retry = RetryPolicy(max_attempts=2, base_delay_s=0.001)
    with faults.injected("data_io:99"):
        with pytest.raises(DataReadFault):
            list(it)


def test_idx_file_read_retry(tmp_path):
    from deeplearning4j_tpu_torch.datasets.mnist import _read_idx

    path = tmp_path / "toy-idx"
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 2))
        f.write(struct.pack(">II", 2, 3))
        f.write(bytes(range(6)))
    with faults.injected("data_io:1") as plan:
        arr = _read_idx(str(path))
    assert plan.injected["data_io"] == 1
    assert arr.shape == (2, 3) and arr[1, 2] == 5


# ------------------------------------------------------------ checkpoints
def test_manifest_checksums_equal_jax_for_the_same_weights(tmp_path):
    """The port's manifest names every leaf as ``jax.tree_util.keystr``
    does and gives the crc32 of the same host bytes."""
    jn = JaxNet(_jax_conf()).init()
    x, y = _data()
    jn.fit_batch((x, y))
    net = _model()
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, jn.params),
                    jax.tree_util.tree_map(np.asarray, jn.state))
    load_jax_opt_state(net, jax.tree_util.tree_map(np.asarray, jn.opt_state),
                       jn.step_count)
    ckpt = _ckpt(tmp_path)
    ckpt.save(1, net)
    manifest = json.load(open(os.path.join(ckpt.directory,
                                           "manifest-1.json")))
    want = jax_ckpt._flatten({"params": jn.params, "state": jn.state,
                              "opt_state": jn.opt_state})
    assert manifest["structure"] == sorted(want)
    assert manifest["checksums"] == {k: jax_ckpt._checksum(v)
                                     for k, v in want.items()}
    assert manifest["step"] == 1
    ckpt.close()


def test_save_restore_round_trip_and_listener(tmp_path):
    net = _model()
    x, y = _data()
    for _ in range(3):
        net.fit_batch((x, y))
    ckpt = TrainingCheckpointer(tmp_path / "a", keep_last=2)  # on a thread
    ckpt.save(3, net)
    ckpt.wait()
    fresh = _model(seed=9)
    assert ckpt.restore_latest(fresh) == 3 and fresh.step_count == 3
    for a, b in zip(flatten([net.params, net.state, net.opt_state]).values(),
                    flatten([fresh.params, fresh.state,
                             fresh.opt_state]).values()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(fresh.output(x).numpy(),
                                  net.output(x).numpy())
    ckpt.close()
    ckpt.close()  # idempotent

    lst = AsyncCheckpointListener(str(tmp_path / "b"),
                                  save_every_n_iterations=2, keep_last=2)
    net2 = _model()
    net2.set_listeners(lst)
    net2.fit(ArrayDataSetIterator(np.tile(x, (3, 1)), np.tile(y, (3, 1)),
                                  batch_size=6), epochs=2)
    # saves at iterations 2 and 4, and at fit end (step 6); keep-last-2
    assert lst.checkpointer.all_steps() == [4, 6]
    assert all(os.path.exists(os.path.join(lst.checkpointer.directory,
                                           f"manifest-{s}.json"))
               for s in (4, 6))
    assert not os.path.exists(os.path.join(lst.checkpointer.directory,
                                           "manifest-2.json"))


def test_ckpt_io_retry_then_succeed_and_exhaustion(tmp_path):
    net = _model()
    ckpt = _ckpt(tmp_path)
    with faults.injected("ckpt_io:2") as plan:
        ckpt.save(1, net)
    assert plan.injected["ckpt_io"] == 2 and ckpt.all_steps() == [1]
    with faults.injected("ckpt_io:99"):
        with pytest.raises(CheckpointIOFault):
            ckpt.save(2, net)
        with pytest.raises(CheckpointIOFault):
            ckpt.restore(1, _model(seed=9))
    ckpt.close()


@pytest.mark.parametrize("how", ["truncated", "injected"])
def test_corrupted_latest_falls_back(tmp_path, how):
    net = _model()
    x, y = _data()
    ckpt = _ckpt(tmp_path, keep_last=3)
    spec = "ckpt_corrupt:1@step==3" if how == "injected" else "data_io:1@call>99"
    with faults.injected(spec) as plan:
        for step in (1, 2, 3):
            net.fit_batch((x, y))
            ckpt.save(step, net)
    if how == "truncated":
        ckpt._corrupt_step(3)
    else:
        assert plan.injected["ckpt_corrupt"] == 1
    with pytest.warns(UserWarning, match="not restorable"):
        assert _ckpt(tmp_path).restore_latest(_model(seed=9)) == 2
    ckpt.close()


def test_manifest_mismatch_detected(tmp_path):
    ckpt = _ckpt(tmp_path)
    ckpt.save(1, _model())
    path = os.path.join(ckpt.directory, "manifest-1.json")
    manifest = json.load(open(path))
    manifest["checksums"][next(iter(manifest["checksums"]))] = 12345
    json.dump(manifest, open(path, "w"))
    with pytest.raises(CheckpointCorrupt):
        ckpt.restore(1, _model(seed=9))
    ckpt.close()


def test_retention_never_deletes_last_known_good(tmp_path):
    net = _model()
    x, y = _data()
    ckpt = _ckpt(tmp_path, keep_last=2)
    net.fit_batch((x, y))
    ckpt.save(1, net)
    ckpt.restore(1, net)          # step 1 is now the last known-good
    for step in (2, 3, 4):
        net.fit_batch((x, y))
        ckpt.save(step, net)
    assert ckpt.all_steps() == [1, 3, 4]
    ckpt.close()


def test_checksum_is_the_jax_checksum_of_the_same_bytes():
    for t in (torch.arange(7, dtype=torch.float32), torch.tensor(3.5),
              torch.ones(2, 3, dtype=torch.int32)):
        assert checksum(t) == jax_ckpt._checksum(np.asarray(t.numpy()))
    b = torch.linspace(-2, 2, 9).to(torch.bfloat16)
    assert checksum(b) == jax_ckpt._checksum(
        jax.numpy.asarray(b.float().numpy(), jax.numpy.bfloat16))


def test_listener_needs_eager_scores():
    assert AsyncCheckpointListener.needs_eager_score
    assert not TrainingListener.needs_eager_score
