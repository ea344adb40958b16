"""The port's ParallelInference against the JAX package's.

The scenarios of ``tests/test_parallel.py`` (``TestParallelInference``,
``TestInferencePadBatches``) and ``tests/test_faults.py``
(``TestInferenceSelfHealing``) through both packages' batching queues on
the CPU: the same results (a JAX-built network, restored by the port from
its zip, within 1e-5 of the JAX network), the same pow2 batch shapes, the
same self-healing outcomes and recovery counters. Then what is the port's
own: batches staged on the queue's device and sliced there, a ``mesh``
on another device type refused, the device check against the model's,
``output`` with a mesh as a collective over "data" in a gloo world of 2
and 4 (against the JAX package's ``output`` under its mesh), and replicas of a
real recurrent network running ``output`` at once while the op registry's
choice cache evicts under them.
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_serving_gateway import (  # noqa: F401 (the autouse fixture)
    PKGS, PORT, _isolate, both, jax_zip,
)

TOL = 1e-5


class _FakeModel:
    """Host-only stand-in: output(x) doubles the batch."""

    def __init__(self, fail_on=None):
        self.fail_on = fail_on

    def output(self, x):
        x = np.asarray(x)
        if self.fail_on is not None and x.shape[0] == self.fail_on:
            raise ValueError("bad batch")
        return x * 2.0


def _jax_dense(seed):
    from test_torch_serving_gateway import jax_dense

    return jax_dense(seed, n_in=8, hidden=16, n_out=4)


@pytest.fixture(scope="module")
def dense_pair(tmp_path_factory):
    """{pkg name: net}, seed 9 (the JAX test's model), and seed 2."""
    d = tmp_path_factory.mktemp("pi")
    out = {}
    for seed in (9, 2):
        jnet = _jax_dense(seed)
        out[seed] = {"jax": jnet,
                     "torch": PORT.restore(jax_zip(jnet, d / f"{seed}.zip"))}
    return out


def _batched_async(p, net, xs):
    pi = p.pi(net, batch_limit=8).start()
    try:
        queues = [pi.submit(x) for x in xs]
        return np.stack([q.get(timeout=30) for q in queues])
    finally:
        pi.stop()


def test_batched_async(dense_pair, rng):
    xs = [rng.normal(size=(8,)).astype(np.float32) for _ in range(16)]
    nets = dense_pair[9]
    jx, pt = (_batched_async(p, nets[p.name], xs) for p in PKGS)
    direct = np.asarray(nets["jax"].output(np.stack(xs)))
    np.testing.assert_allclose(jx, direct, rtol=1e-5)
    np.testing.assert_allclose(pt, direct, rtol=0, atol=TOL)
    np.testing.assert_allclose(pt, jx, rtol=0, atol=TOL)


def _padded(p, net, xs):
    pi = p.pi(net, batch_limit=8, queue_timeout_s=0.05).start()
    try:
        queues = [pi.submit(x) for x in xs]
        return np.stack([q.get(timeout=30) for q in queues]), pi.batches \
            if p is PORT else None
    finally:
        pi.stop()


def test_padded_partial_batches_return_correct_results(dense_pair, rng):
    xs = rng.normal(size=(5, 8)).astype(np.float32)     # -> bucket 8
    nets = dense_pair[2]
    (jx, _), (pt, batches) = (_padded(p, nets[p.name], xs) for p in PKGS)
    want = np.asarray(nets["jax"].output(xs))
    np.testing.assert_allclose(jx, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pt, want, rtol=0, atol=TOL)
    assert 1 <= batches <= 5


def _dispatched_sizes(p, net, rng):
    seen = []
    orig = net.output

    def spy(x, **kw):
        seen.append(np.shape(x)[0])
        return orig(x, **kw)

    net.output = spy
    pi = p.pi(net, batch_limit=16, queue_timeout_s=0.02).start()
    try:
        for n in (3, 5, 7, 11, 13):
            qs = [pi.submit(rng.normal(size=8).astype(np.float32))
                  for _ in range(n)]
            for q in qs:
                q.get(timeout=30)
    finally:
        pi.stop()
        del net.output
    return seen


def test_pad_batches_bounds_the_shape_set(dense_pair, rng):
    for p in PKGS:
        seen = _dispatched_sizes(p, dense_pair[2][p.name], rng)
        assert seen and all(s == 1 or (s & (s - 1)) == 0 for s in seen), seen


# ------------------------------------------------------------ self-healing
def _crash_restarts(p):
    p.monitoring.enable()
    pi = p.pi(_FakeModel(), queue_timeout_s=0.001).start()
    try:
        with p.faults.injected("infer_crash:1"):
            q1 = pi.submit(np.ones(4))
            r1 = q1.get(timeout=10)
            q2 = pi.submit(np.ones(4))
            r2 = p.inference.resolve(q2.get(timeout=10))
        return [type(r1).__name__, r2.tolist(), pi.restarts, pi.healthy(),
                'dl4j_recovery_total{component="serving",'
                'outcome="worker_restarted"} 1'
                in p.monitoring.metrics_text()]
    finally:
        pi.stop()


def test_injected_crash_fans_back_and_restarts():
    jx, pt = both(_crash_restarts)
    assert pt == jx == ["InferenceWorkerCrash", [2.0] * 4, 1, True, True]


def _dead_thread(p):
    p.monitoring.enable()
    pi = p.pi(_FakeModel(), queue_timeout_s=0.001).start()
    try:
        dead = threading.Thread(target=lambda: None)
        dead.start()
        dead.join()
        pi._worker = dead
        q = pi.submit(np.ones(4))
        return [p.inference.resolve(q.get(timeout=10)).tolist(), pi.restarts,
                'dl4j_recovery_total{component="serving",'
                'outcome="dead_thread"} 1' in p.monitoring.metrics_text()]
    finally:
        pi.stop()


def test_dead_thread_detected_at_submit():
    jx, pt = both(_dead_thread)
    assert pt == jx == [[2.0] * 4, 1, True]


def _crash_storm(p):
    pi = p.pi(_FakeModel(), batch_limit=4, queue_timeout_s=0.001).start()
    try:
        with p.faults.injected("infer_crash:0.5", seed=3):
            queues = [pi.submit(np.full(4, i)) for i in range(32)]
            outcomes = [q.get(timeout=30) for q in queues]
        errors = [o for o in outcomes if isinstance(o, BaseException)]
        return [len(outcomes), bool(errors),
                all(isinstance(e, p.faults.InferenceWorkerCrash)
                    for e in errors)]
    finally:
        pi.stop()


def test_no_future_hangs_under_crash_storm():
    jx, pt = both(_crash_storm)
    assert pt == jx == [32, True, True]


def _forward_error(p):
    pi = p.pi(_FakeModel(fail_on=1), queue_timeout_s=0.001).start()
    try:
        r = pi.submit(np.ones(4)).get(timeout=10)
        return [type(r).__name__, str(r), pi.restarts]
    finally:
        pi.stop()


def test_forward_error_is_not_a_restart():
    jx, pt = both(_forward_error)
    assert pt == jx == ["ValueError", "bad batch", 0]


def _healthz_degraded(p):
    gw = p.gateway()
    gw.register_model("m", "v1", _FakeModel(), warmup=False)
    try:
        before = gw._healthz({})
        gw.registry.get("m", "v1").pi._record_restart("worker_restarted")
        return [before, gw._healthz({})]
    finally:
        gw.registry.shutdown()


def test_gateway_healthz_reports_degraded():
    jx, pt = both(_healthz_degraded)
    assert pt == jx
    before, after = pt
    assert before["status"] == "alive" and before["degraded"] == []
    assert after["status"] == "degraded" and after["degraded"] == ["m/v1"]
    assert after["workers"]["m/v1"]["worker_restarts"] == 1


def _slow_worker(p):
    pi = p.pi(_FakeModel(), queue_timeout_s=0.001).start()
    try:
        with p.faults.injected("slow_worker:1", delay_s=0.2) as plan:
            r = p.inference.resolve(pi.submit(np.ones(2)).get(timeout=10))
            return [r.tolist(), plan.injected["slow_worker"], pi.restarts]
    finally:
        pi.stop()


def test_slow_worker_delays_without_a_restart():
    jx, pt = both(_slow_worker)
    assert pt == jx == [[2.0, 2.0], 1, 0]


# ------------------------------------------------------- the port's own
class _TensorModel:
    """Records what reaches ``output``: the port stages a tensor on the
    queue's device; returns a tensor the queue slices there."""

    def __init__(self):
        self.seen = []

    def output(self, x):
        self.seen.append((type(x).__name__, str(x.device), tuple(x.shape),
                          torch.is_grad_enabled()))
        return x * 3.0


def test_batches_are_staged_and_sliced_on_the_device():
    model = _TensorModel()
    pi = PORT.pi(model, batch_limit=8, queue_timeout_s=0.05).start()
    try:
        qs = [pi.submit(np.full(3, float(i), np.float32)) for i in range(3)]
        outs = [q.get(timeout=10) for q in qs]
    finally:
        pi.stop()
    assert all(isinstance(o, np.ndarray) for o in outs)
    np.testing.assert_allclose(np.stack(outs),
                               3.0 * np.arange(3)[:, None] * np.ones(3))
    # one padded batch of 4 rows, as a tensor on the CPU, autograd off
    assert model.seen == [("Tensor", "cpu", (4, 3), False)]
    assert pi.batches == 1


def test_mesh_and_device_checks(dense_pair):
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    net = dense_pair[2]["torch"]

    class CardMesh:
        device_type = "cuda"

    with pytest.raises(ValueError, match="mesh runs on cuda"):
        ParallelInference(net, mesh=CardMesh(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ParallelInference(net)

    class OnCard:
        device = torch.device("cuda", 0)

        def output(self, x):
            return x

    with pytest.raises(ValueError, match="lives on"):
        ParallelInference(OnCard(), device="cpu")


def _lstm_net(units=12, V=13):
    from deeplearning4j_tpu_torch.nn.conf.builders import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(7).list()
            .layer(LSTMLayer(n_out=units))
            .layer(RnnOutputLayer(n_out=V, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(V, 8)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def test_replicas_run_output_at_once_while_the_cache_evicts(monkeypatch):
    """Four replicas of one recurrent network, each batch a new padded
    shape, with the op registry's choice cache bounded at 2 entries: every
    future resolves to the direct ``output`` of its rows."""
    from deeplearning4j_tpu_torch.ops import registry

    monkeypatch.setattr(registry, "CHOICE_CACHE_SIZE", 2)
    net = _lstm_net()
    rng = np.random.default_rng(0)
    xs = np.eye(13, dtype=np.float32)[rng.integers(0, 13, (96, 6))]
    want = net.output(xs).numpy()
    pi = PORT.pi(net, batch_limit=8, queue_timeout_s=0.002,
                 replicas=4).start()
    try:
        outs = [None] * len(xs)

        def client(lo):
            for i in range(lo, len(xs), 6):
                outs[i] = pi.submit(xs[i]).get(timeout=30)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert pi.replicas() == 4 and pi.restarts == 0
    finally:
        pi.stop()
    for i, o in enumerate(outs):
        assert not isinstance(o, BaseException), o
        np.testing.assert_allclose(o, want[i], rtol=0, atol=TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_padded_batches_on_card_through_the_lstm_kernel(cuda_device):
    """On the card: a recurrent network behind ParallelInference answers
    within 1e-5 of its direct ``output``, and each dispatched batch
    launches the LSTM forward kernel once."""
    from deeplearning4j_tpu_torch.ops.cuda import FUSED_LSTM

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        net = _lstm_net(units=64).to(cuda_device)
        xs = np.eye(13, dtype=np.float32)[
            np.random.default_rng(1).integers(0, 13, (5, 16))]
        want = net.output(xs).cpu().numpy()
        from deeplearning4j_tpu_torch.parallel import ParallelInference

        pi = ParallelInference(net, batch_limit=8, queue_timeout_s=0.05,
                               device=cuda_device).start()
        try:
            FUSED_LSTM.launches = 0
            outs = [q.get(timeout=60) for q in
                    [pi.submit(x) for x in xs]]
            batches = pi.batches
        finally:
            pi.stop()
        np.testing.assert_allclose(np.stack(outs), want, rtol=0, atol=TOL)
        assert FUSED_LSTM.launches == batches
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_output_over_a_mesh(tmp_path):
    """ParallelInference(mesh=...).output in gloo worlds of 2 and 4
    against the JAX package's output under its mesh (B 8 and a
    ragged 5, which pads): within 1e-5, every rank the same; the
    control (every rank running the first slice) misses."""
    from deeplearning4j_tpu.parallel import DeviceMesh as JaxMesh
    from deeplearning4j_tpu.parallel import (
        ParallelInference as JaxParallelInference,
    )
    from deeplearning4j_tpu_torch.parallel import launch
    from test_torch_serving_gateway import jax_dense

    import torch_parallel_ranks as ranks

    jnet = jax_dense(9, n_in=8, hidden=16, n_out=4)
    zpath = jax_zip(jnet, tmp_path / "dense.zip")
    rng = np.random.default_rng(5)
    xs = {"even": rng.normal(size=(8, 8)).astype(np.float32),
          "ragged": rng.normal(size=(5, 8)).astype(np.float32)}
    jpi = JaxParallelInference(jnet, mesh=JaxMesh(data=8))
    want = {n: np.asarray(jpi.output(x)) for n, x in xs.items()}
    for world in (2, 4):
        outs = launch.run(ranks.inference_world, world, device="cpu",
                          args=({"zip": zpath, "xs": xs},), threads=1,
                          timeout=120)
        for r in outs:
            for n in xs:
                np.testing.assert_allclose(r[n], want[n], rtol=0,
                                           atol=1e-5)
                np.testing.assert_array_equal(r[n], outs[0][n])
            assert np.abs(r["control"] - want["even"]).max() > 1e-3
