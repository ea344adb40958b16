"""The port's threshold-encoded gradient sharing and parameter averaging
(``parallel/compression.py``, ``parallel/param_averaging.py``) against the
JAX package's.

One gloo world of 4 ranks (``torch_parallel_ranks.local_sgd_world``) runs
every case; the JAX side runs its trainers with 4 replicas too: a
(data 4, model 2) mesh of the conftest's 8 virtual devices (the batch splits
over "data" only), and its multi-slice mesh over the first 4 devices.
Tolerances: the trajectories 1e-5 (1e-4 relative on losses); the masked
LSTM rounds 1e-5 (2e-5 relative), as the JAX tests state them. The
encoded trainers are held step for step over their first 20 steps, and
to their convergence after 400.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import LSTMLayer as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOutput
from deeplearning4j_tpu.optimize.updaters import Adam as JaxAdam
from deeplearning4j_tpu.optimize.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.parallel import DeviceMesh as JaxMesh
from deeplearning4j_tpu.parallel import (
    EncodedGradientTrainer as JaxEncoded,
)
from deeplearning4j_tpu.parallel import (
    ParameterAveragingTrainer as JaxAveraging,
)
from deeplearning4j_tpu.parallel import multi_slice_mesh as jax_multi_slice
from deeplearning4j_tpu.parallel import threshold_encode as jax_encode
from deeplearning4j_tpu_torch.parallel import (
    launch, message_density, threshold_encode,
)

import torch_parallel_ranks as ranks

TOL = dict(rtol=1e-4, atol=1e-5)
TOL_MASKED = dict(rtol=2e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mse(params, x, y):
    return ((x @ params["w"] - y) ** 2).mean()


def _seq_net(seed=21):
    conf = (JaxNNC.builder().seed(seed).updater(JaxSgd(lr=0.05)).list()
            .layer(JaxLSTM(n_out=8))
            .layer(JaxRnnOutput(n_out=3, activation="softmax",
                                loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(4, 6)).build())
    return JaxNet(conf).init()


def _masked_data(rng, n=256, T=6, F=4, C=3):
    x = rng.normal(size=(n, T, F)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[np.argmax(x[..., :C], axis=-1)]
    mask = np.ones((n, T), np.float32)
    for i, L in enumerate(rng.integers(2, T + 1, n)):
        mask[i, L:] = 0.0
    return x, y, mask


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(42)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    true_w = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    ax = rng.normal(size=(32, 16)).astype(np.float32)
    ay = rng.normal(size=(32, 1)).astype(np.float32)
    tx = rng.normal(size=(32, 3)).astype(np.float32)
    ty = rng.normal(size=(32, 1)).astype(np.float32)
    hx = rng.normal(size=(32, 4)).astype(np.float32)
    hy = rng.normal(size=(32, 1)).astype(np.float32)
    AX = rng.normal(size=(4 * 64, 6)).astype(np.float32)
    AY = AX @ rng.normal(size=(6, 1)).astype(np.float32)
    sx, sy, smask = _masked_data(rng)
    lmask = np.zeros_like(smask)
    lmask[:, 1] = 1.0
    y_garbage = sy.copy()
    y_garbage[:, 2:] = 5.0
    net = _seq_net()
    p = dict(
        encoded=dict(x=X, y=X @ true_w, steps=400, early=20, ax=ax, ay=ay,
                     tx=tx, ty=ty, hx=hx, hy=hy),
        averaging=dict(x=AX, y=AY),
        masked=dict(net=dict(json=net.conf.to_json(), kind="mln",
                             params=_np(net.params), state=_np(net.state)),
                    x=sx, y=sy, mask=smask, lmask=lmask,
                    y_garbage=y_garbage))
    port = launch.run(ranks.local_sgd_world, 4, device="cpu", args=(p,),
                      threads=1, timeout=300)
    return p, true_w, port


def _jax_encoded(mesh, steps, x, y, w0, **kw):
    tr = JaxEncoded(_mse, JaxSgd(lr=kw.pop("lr")), mesh, **kw)
    carry = tr.init({"w": jnp.zeros(w0)})
    losses = []
    for _ in range(steps):
        carry, loss = tr.fit_batch(carry, x, y)
        losses.append(float(loss))
    return carry, losses


def _dp4():
    return JaxMesh(data=4, model=2).mesh


class TestEncodedGradientSharing:
    def test_encode_and_residual(self):
        import torch

        g = np.asarray([0.5, -0.002, 0.0009, -3.0, 0.001], np.float32)
        q, r = threshold_encode(torch.as_tensor(g), 0.001)
        jq, jr = jax_encode(jnp.asarray(g), 0.001)
        np.testing.assert_allclose(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr))
        np.testing.assert_allclose((q + r).numpy(), g, rtol=1e-6)
        assert float(message_density([q], 0.001)) == pytest.approx(0.8)

    def test_trainer_matches_jax_and_converges(self, case):
        """Step for step while no entry sits within rounding of +-thr (the
        ternary code is discontinuous there: on these data the two
        packages' trajectories part at step 27), then both converge."""
        p, true_w, port = case
        e = p["encoded"]
        early, _ = _jax_encoded(_dp4(), e["early"], e["x"], e["y"], (4, 1),
                                lr=0.3, threshold=5e-3, adaptive=False)
        carry, losses = _jax_encoded(_dp4(), e["steps"], e["x"], e["y"],
                                     (4, 1), lr=0.3, threshold=5e-3,
                                     adaptive=False)
        n = e["early"]
        assert losses[-1] < 0.05 * losses[0]
        for rank, r in enumerate(port):
            got_losses, w, (w_early, residual) = r["encoded"]
            np.testing.assert_allclose(got_losses[:n], losses[:n], **TOL)
            np.testing.assert_allclose(
                w_early, np.asarray(early["params"]["w"]), **TOL)
            np.testing.assert_allclose(
                residual, np.asarray(early["residual"]["w"][rank]), **TOL)
            assert got_losses[-1] < 0.05 * got_losses[0]
            np.testing.assert_allclose(w, true_w, atol=0.3)

    def test_adaptive_threshold_tracks_density(self, case):
        p, _, port = case
        e = p["encoded"]
        carry, _ = _jax_encoded(_dp4(), 50, e["ax"], e["ay"], (16, 1),
                                lr=0.01, threshold=1e-6, target_density=0.25)
        for r in port:
            assert r["adaptive_thr"] > 1e-6 * 5
            assert r["adaptive_thr"] == pytest.approx(float(carry["thr"]),
                                                      rel=1e-5)

    def test_tuple_params_and_bf16_dtypes(self, case):
        for r in case[2]:
            w1, w2, res, loss = r["tuple_bf16"]
            assert (w1, w2, res) == ("torch.bfloat16", "torch.float32",
                                     "torch.bfloat16")
            assert np.isfinite(loss)

    def test_stateful_updaters_are_refused(self, case):
        for r in case[2]:
            assert r["sgd_only"][0] == "ValueError"


class TestMultiSlice:
    def test_hierarchical_encoded_trainer_matches_jax(self, case):
        p, true_w, port = case
        e = p["encoded"]
        carry, losses = _jax_encoded(
            jax_multi_slice(2, devices=jax.devices()[:4]), e["steps"],
            e["x"], e["y"], (4, 1), lr=0.3, axis="dcn", ici_axis="data",
            threshold=5e-3, adaptive=False)
        n = e["early"]
        for r in port:
            got_losses, w = r["hier"]
            np.testing.assert_allclose(got_losses[:n], losses[:n], **TOL)
            assert got_losses[-1] < 0.05 * got_losses[0]
            np.testing.assert_allclose(w, true_w, atol=0.3)

    def test_hierarchical_matches_flat_when_one_slice_per_device(self, case):
        for r in case[2]:
            hier, flat = r["hier_one_slice"]
            np.testing.assert_allclose(hier, flat, rtol=1e-5, atol=1e-6)


class TestParameterAveraging:
    def _jax(self, upd, k, rounds, x, y, **kw):
        tr = JaxAveraging(_mse, upd, _dp4(), averaging_frequency=k)
        carry = tr.init({"w": jnp.zeros((6, 1))})
        losses = []
        for _ in range(rounds):
            carry, loss = tr.fit_round(carry, x, y, **kw)
            losses.append(float(loss))
        return losses, np.asarray(tr.params(carry)["w"])

    @pytest.mark.parametrize("name,upd,k,rounds", [
        ("adam_k4", JaxAdam(lr=0.05), 4, 60),
        ("sgd_k1", JaxSgd(lr=0.1), 1, 10),
        ("sgd_k4", JaxSgd(lr=0.1), 4, 3)])
    def test_rounds_match_jax(self, case, name, upd, k, rounds):
        p, _, port = case
        a = p["averaging"]
        n = len(a["x"]) if k == 4 else 64
        losses, w = self._jax(upd, k, rounds, a["x"][:n], a["y"][:n])
        for r in port:
            np.testing.assert_allclose(r[name][0], losses, **TOL)
            np.testing.assert_allclose(r[name][1], w, **TOL)

    def test_k4_differs_from_sync_but_replicas_resync(self, case):
        port = case[2]
        assert not np.allclose(port[0]["sgd_k4"][1], port[0]["sgd_k1"][1],
                               atol=1e-6)
        for r in port[1:]:
            np.testing.assert_array_equal(r["sgd_k4"][1],
                                          port[0]["sgd_k4"][1])

    def test_lost_replicas_are_dropped_from_the_average(self, case):
        p, _, port = case
        a = p["averaging"]
        tr = JaxAveraging(_mse, JaxSgd(lr=0.1), _dp4(), averaging_frequency=2)
        carry = tr.init({"w": jnp.zeros((6, 1))})
        losses = []
        for _ in range(3):
            carry, loss = tr.fit_round(carry, a["x"][:128], a["y"][:128],
                                       lost=[1])
            losses.append(float(loss))
        for r in port:
            np.testing.assert_allclose(r["lost"][0], losses, **TOL)
            np.testing.assert_allclose(r["lost"][1],
                                       np.asarray(tr.params(carry)["w"]),
                                       **TOL)
            assert "every replica" in r["lost_all"][1]


class TestMaskedLocalSGD:
    def _jax_rounds(self, s, k, n, rounds, y=None, lmask=None):
        net = _seq_net()
        loss_fn, (p0, s0) = net.as_loss_fn(train=True)
        tr = JaxAveraging(loss_fn, JaxSgd(lr=0.05), _dp4(),
                          averaging_frequency=k, stateful=True)
        carry = tr.init(p0, state=s0, rng=jax.random.key(0))
        kw = {} if lmask is None else {"label_mask": lmask[:n]}
        losses = []
        for _ in range(rounds):
            carry, loss = tr.fit_round(carry, s["x"][:n],
                                       (s["y"] if y is None else y)[:n],
                                       mask=s["mask"][:n], **kw)
            losses.append(float(loss))
        return losses, _np(tr.params(carry))

    def _check(self, got, want):
        np.testing.assert_allclose(got[0], want[0], **TOL_MASKED)
        for pa, pb in zip(got[1], want[1]):
            for k in pb:
                np.testing.assert_allclose(pa[k], pb[k], **TOL_MASKED)

    def test_k1_round_equals_jax_and_a_global_batch_step(self, case):
        """K = 1 is sync data parallelism, masks included: the rounds are
        the JAX trainer's and the JAX net's own fit_batch on the global
        batch, however the padding falls across the 4 replicas."""
        from deeplearning4j_tpu.datasets import DataSet

        s = case[0]["masked"]
        want = self._jax_rounds(s, 1, 64, 3)
        net = _seq_net()
        fit = [float(net.fit_batch(DataSet(s["x"][:64], s["y"][:64],
                                           features_mask=s["mask"][:64])))
               for _ in range(3)]
        np.testing.assert_allclose(want[0], fit, rtol=2e-5)
        for r in case[2]:
            self._check(r[("masked", "k1")], want)

    def test_k4_masked_rounds_use_local_valid_counts(self, case):
        s = case[0]["masked"]
        want = self._jax_rounds(s, 4, 256, 1)
        for r in case[2]:
            self._check(r[("masked", "k4")], want)

    def test_mlm_dual_masks_on_k4_path(self, case):
        s = case[0]["masked"]
        want = self._jax_rounds(s, 4, 64, 1, lmask=s["lmask"])
        for r in case[2]:
            self._check(r[("masked", "mlm")], want)
            assert r[("masked", "mlm")][0] == pytest.approx(
                r[("masked", "mlm_garbage")][0], rel=1e-5)

    def test_masks_need_the_stateful_surface(self, case):
        for r in case[2]:
            assert "stateful=True" in r["unmasked_stateless"][1]
