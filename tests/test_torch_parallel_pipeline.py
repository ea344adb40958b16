"""The port's GPipe and HeteroPipe (``parallel/pipeline.py``) and
``resnet50_pipeline_plan`` against the JAX package's.

Mirrors ``tests/test_parallel.py``'s ``TestPipelineParallel`` (dense stages,
the pipelined train step, the BERT zoo model's encoder stack) and the
HeteroPipe half of ``TestConvShardingAndHeteroPipe``. The JAX side runs its
pipelines over (pipe 4) of the conftest's virtual devices; the port's runs
as a gloo world of 4 ranks, one stage a rank
(``torch_parallel_ranks.pipeline_world``), and as the one-device replay
(``mesh=None``); both get the same numpy inputs and params. Tolerances are
the JAX tests': GPipe 2e-4 relative / 2e-5 absolute, the BERT stack 2e-4 /
2e-4, HeteroPipe 1e-5 / 1e-6 forward and 1e-4 / 1e-5 gradients; the train
step's losses and params 1e-4 / 1e-5; the packed buffers equal. Every
rank's output must equal every other's bit for bit (the output is
replicated). The controls: the pipeline with one rotation dropped (the
first tick's, and the fourth's) misses the sequential reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import DeviceMesh as JaxMesh
from deeplearning4j_tpu_torch.parallel import launch

import torch_parallel_ranks as ranks

TOL = dict(rtol=2e-4, atol=2e-5)
TOL_BERT = dict(rtol=2e-4, atol=2e-4)
TOL_HETERO = dict(rtol=1e-5, atol=1e-6)
TOL_HETERO_GRAD = dict(rtol=1e-4, atol=1e-5)
TOL_TRAIN = dict(rtol=1e-4, atol=1e-5)
DIMS = [16, 12, 8, 4, 4]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_stage(p, x):
    return jnp.tanh(x @ p["W"] + p["b"])


def _jax_stage_nobias(p, x):
    return jnp.tanh(x @ p["W"])


def _jax_mesh():
    return JaxMesh(data=1, pipe=4, devices=jax.devices()[:4])


def _jax_value_and_grads(fn, tree):
    y = np.asarray(fn(tree))
    g = jax.grad(lambda t: (fn(t) ** 2).sum())(tree)
    return y, _np(g)


def _bert():
    from deeplearning4j_tpu.zoo import Bert

    return Bert(vocab_size=64, max_len=8, d_model=32, n_layers=4,
                n_heads=4, d_ff=64, num_classes=2, dropout=0.0,
                dtype="float32", seed=5).init()


@pytest.fixture(scope="module")
def case():
    from deeplearning4j_tpu.nn.layers.attention import (
        TransformerEncoderLayer,
    )
    from deeplearning4j_tpu.optimize import Sgd
    from deeplearning4j_tpu.parallel import (
        GPipe, HeteroPipe, pack_stage_params, pipeline_train_step,
        stack_stage_params,
    )

    rng = np.random.default_rng(21)
    D = 16
    stages = [{"W": (rng.normal(size=(D, D)) * 0.3).astype(np.float32),
               "b": (rng.normal(size=(D,)) * 0.1).astype(np.float32)}
              for _ in range(4)]
    stacked = _np(stack_stage_params(
        [{k: jnp.asarray(v) for k, v in s.items()} for s in stages]))
    x = rng.normal(size=(16, D)).astype(np.float32)
    Dt = 8
    train = {"params": {
        "stages": {"W": (rng.normal(size=(4, Dt, Dt)) * 0.4).astype(
            np.float32), "b": np.zeros((4, Dt), np.float32)},
        "head": {"W": rng.normal(size=(Dt, 2)).astype(np.float32)}},
        "x": rng.normal(size=(8, Dt)).astype(np.float32),
        "y": rng.normal(size=(8, 2)).astype(np.float32), "steps": 10}
    net = _bert()
    enc = [(l, p) for l, p in zip(net.layers, net.params)
           if isinstance(l, TransformerEncoderLayer)]
    bert = {"json": net.conf.to_json(),
            "stacked": _np(stack_stage_params([p for _, p in enc])),
            "h": rng.normal(size=(8, 8, 32)).astype(np.float32)}
    hstages = []
    for s in range(4):
        W = (rng.normal(size=(DIMS[s], DIMS[s + 1])) * 0.4).astype(np.float32)
        hstages.append({"W": W, "b": np.zeros(DIMS[s + 1], np.float32)}
                       if s % 2 == 0 else {"W": W})
    hetero = {"stages": hstages, "shapes": [(d,) for d in DIMS],
              "x": rng.normal(size=(6, 16)).astype(np.float32)}
    p = {"gpipe": {"stacked": stacked, "x": x}, "train": train,
         "bert": bert, "hetero": hetero}

    # the JAX package's runs
    mesh = _jax_mesh()
    jax_out = {}
    pipe = GPipe(_jax_stage, mesh, n_microbatches=4)
    with mesh.mesh:
        jax_out["gpipe"] = _jax_value_and_grads(
            lambda s: pipe(s, jnp.asarray(x)),
            jax.tree_util.tree_map(jnp.asarray, stacked))
        jax_out["sequential"] = np.asarray(pipe.sequential_reference(
            jax.tree_util.tree_map(jnp.asarray, stacked), jnp.asarray(x)))
        step = pipeline_train_step(
            pipe, lambda pred, y: jnp.mean((pred - y) ** 2), Sgd(lr=0.2),
            lambda hp, h: h @ hp["W"])
        params = jax.tree_util.tree_map(jnp.asarray, train["params"])
        opt = Sgd(lr=0.2).init_state(params)
        losses = []
        for i in range(train["steps"]):
            params, opt, loss = step(params, opt, jnp.asarray(i, jnp.int32),
                                     jnp.asarray(train["x"]),
                                     jnp.asarray(train["y"]))
            losses.append(float(loss))
        jax_out["train"] = (losses, _np(params))
        e = enc[0][0]
        bpipe = GPipe(lambda q, h: e.apply(q, {}, h, train=False)[0], mesh,
                      n_microbatches=4)
        jax_out["bert"] = _jax_value_and_grads(
            lambda s: bpipe(s, jnp.asarray(bert["h"])),
            jax.tree_util.tree_map(jnp.asarray, bert["stacked"]))
        packed, metas = pack_stage_params(
            [{k: jnp.asarray(v) for k, v in s.items()} for s in hstages])
        hpipe = HeteroPipe([_jax_stage if s % 2 == 0 else _jax_stage_nobias
                            for s in range(4)], metas, hetero["shapes"],
                           mesh, n_microbatches=2)
        jax_out["hetero_packed"] = np.asarray(packed)
        jax_out["hetero"] = _jax_value_and_grads(
            lambda q: hpipe(q, jnp.asarray(hetero["x"])), packed)
    port = launch.run(ranks.pipeline_world, 4, device="cpu", args=(p,),
                      threads=1, timeout=300)
    replay = ranks._pipelines(p, None)
    return p, jax_out, port, replay


def _close(got, want, tol):
    y, g = got
    wy, wg = want
    np.testing.assert_allclose(y, wy, **tol)
    for a, b in zip(jax.tree_util.tree_leaves(g),
                    jax.tree_util.tree_leaves(wg)):
        np.testing.assert_allclose(a, b, **tol)


def _runs(case, name):
    """Every rank's result of ``name`` and the replay's."""
    _, _, port, replay = case
    return [r[name] for r in port] + [replay[name]]


class TestPipelineParallel:
    def test_gpipe_matches_sequential(self, case):
        _, jax_out, port, _ = case
        for got in _runs(case, "gpipe"):
            _close(got, jax_out["gpipe"], TOL)
            np.testing.assert_allclose(got[0], jax_out["sequential"], **TOL)
        for r in port[1:]:
            np.testing.assert_array_equal(r["gpipe"][0], port[0]["gpipe"][0])

    def test_dropped_rotation_control_misses(self, case):
        _, jax_out, port, _ = case
        for r in port:
            for at in (1, 3):
                err = np.abs(r[("dropped", at)] - jax_out["sequential"]).max()
                assert err > 1e-2, (at, err)

    def test_checks_at_the_entry(self, case):
        _, _, port, _ = case
        assert port[0]["bad_stages"][0] == "ValueError"
        assert "stacked for 2 stages" in port[0]["bad_stages"][1]
        assert "not divisible by 4 microbatches" in port[0]["bad_batch"][1]
        assert "4 stages but mesh" not in str(port[0]["hetero_bad_stages"])
        assert "shapes must list" in port[0]["hetero_bad_stages"][1]

    def test_gpipe_backward_trains(self, case):
        _, jax_out, _, _ = case
        jl, jp = jax_out["train"]
        for losses, params in _runs(case, "train"):
            np.testing.assert_allclose(losses, jl, **TOL_TRAIN)
            for a, b in zip(jax.tree_util.tree_leaves(params),
                            jax.tree_util.tree_leaves(jp)):
                np.testing.assert_allclose(a, b, **TOL_TRAIN)
            assert losses[-1] < losses[0] * 0.7, losses

    def test_gpipe_bert_encoder_stack(self, case):
        _, jax_out, _, _ = case
        for got in _runs(case, "bert"):
            _close(got, jax_out["bert"], TOL_BERT)
            assert all(np.isfinite(g).all()
                       for g in jax.tree_util.tree_leaves(got[1]))

    def test_pipe1_step_equals_the_sequential_step(self, case):
        """GPipe over a group of one rank (every collective still runs)
        against the same steps run sequentially on the same microbatches:
        equal bit for bit."""
        p = case[0]
        tr = dict(p["train"])
        tr["params"] = {"stages": {k: v[:1] for k, v in
                                   tr["params"]["stages"].items()},
                        "head": tr["params"]["head"]}
        (runs,) = launch.run(ranks.pipeline_world1, 1, device="cpu",
                             args=({"train1": tr},), threads=1, timeout=120)
        (lp, pp), (ls, ps) = runs["pipe1"], runs["sequential"]
        assert lp == ls
        for a, b in zip(jax.tree_util.tree_leaves(pp),
                        jax.tree_util.tree_leaves(ps)):
            np.testing.assert_array_equal(a, b)


class TestHeteroPipe:
    def test_heteropipe_matches_sequential(self, case):
        _, jax_out, port, replay = case
        for r in port + [replay]:
            np.testing.assert_array_equal(r["hetero_packed"],
                                          jax_out["hetero_packed"])
        for got in _runs(case, "hetero"):
            np.testing.assert_allclose(got[0], jax_out["hetero"][0],
                                       **TOL_HETERO)
            np.testing.assert_allclose(got[1], jax_out["hetero"][1],
                                       **TOL_HETERO_GRAD)
            seq = replay["hetero_sequential"]
            np.testing.assert_allclose(got[0], seq[0], **TOL_HETERO)
            np.testing.assert_allclose(got[1], seq[1], **TOL_HETERO_GRAD)

    def test_pack_unpack_round_trip(self):
        from deeplearning4j_tpu.parallel import (
            pack_stage_params as jax_pack,
        )
        from deeplearning4j_tpu_torch.parallel import (
            pack_stage_params, unpack_stage_params,
        )

        rng = np.random.default_rng(3)
        stages = [{"z": rng.normal(size=(3,)).astype(np.float32),
                   "a": {"k": rng.normal(size=(2, 2)).astype(np.float32)}},
                  {"W": rng.normal(size=(5, 1)).astype(np.float32)}]
        packed, metas = pack_stage_params(
            [ranks._t(s) for s in stages])
        jpacked, _ = jax_pack([jax.tree_util.tree_map(jnp.asarray, s)
                               for s in stages])
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        back = unpack_stage_params(packed[0], metas[0])
        assert list(back) == ["z", "a"]
        np.testing.assert_array_equal(back["a"]["k"].numpy(),
                                      stages[0]["a"]["k"])
        bf = pack_stage_params([{"w": torch.ones(3, dtype=torch.bfloat16)}])
        assert bf[0].dtype == torch.float32
        assert unpack_stage_params(bf[0][0], bf[1][0])["w"].dtype == \
            torch.bfloat16

    def _conv_graph(self):
        from deeplearning4j_tpu_torch.nn.conf.builders import (
            NeuralNetConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.layers import (
            ActivationLayer, BatchNormalizationLayer, ConvolutionLayer,
            GlobalPoolingLayer, OutputLayer,
        )

        conf = (NeuralNetConfiguration.builder().seed(11).graph_builder()
                .add_inputs("input")
                .set_input_types(input=InputType.convolutional(8, 8, 3))
                .add_layer("c1", ConvolutionLayer(n_out=8, kernel=(3, 3),
                                                  padding="same"), "input")
                .add_layer("bn1", BatchNormalizationLayer(), "c1")
                .add_layer("r1", ActivationLayer(activation="relu"), "bn1")
                .add_layer("c2", ConvolutionLayer(n_out=8, kernel=(3, 3),
                                                  padding="same"), "r1")
                .add_layer("gp", GlobalPoolingLayer(pooling_type="avg"),
                           "c2")
                .add_layer("output", OutputLayer(n_out=4,
                                                 activation="softmax",
                                                 loss="mcxent"), "gp")
                .set_outputs("output").build())
        return ComputationGraph(conf).init(device="cpu")

    def test_graph_stage_fn_rejects_noncontiguous_cut(self):
        from deeplearning4j_tpu_torch.parallel import graph_stage_fn

        m = self._conv_graph()
        # "r1" depends on bn1, neither in the slice nor the entry
        with pytest.raises(ValueError, match="outside the stage"):
            graph_stage_fn(m, ["r1", "c2"], "c1")

    def test_resnet50_pipeline_plan_shapes(self):
        """The plan equals the JAX package's (its shapes from the
        configuration's types, JAX's from eval_shape), every cut is a
        closed contiguous slice, and the four stages replayed through
        HeteroPipe (then the replicated head) give the net's own
        inference-mode output() within 1e-5 (f32)."""
        from deeplearning4j_tpu.zoo import ResNet50 as JaxResNet50
        from deeplearning4j_tpu.zoo.resnet import (
            resnet50_pipeline_plan as jax_plan,
        )
        from deeplearning4j_tpu_torch.parallel import (
            HeteroPipe, graph_stage_fn, pack_stage_params,
        )
        from deeplearning4j_tpu_torch.zoo import ResNet50
        from deeplearning4j_tpu_torch.zoo.resnet import (
            resnet50_pipeline_plan,
        )

        jm = JaxResNet50(height=16, width=16, num_classes=4,
                         dtype="float32").init()
        m = ResNet50(height=16, width=16, num_classes=4,
                     dtype="float32").init(device="cpu")
        stages, head, shapes = resnet50_pipeline_plan(m, (16, 16, 3))
        assert (stages, head, shapes) == tuple(jax_plan(jm, (16, 16, 3)))
        assert len(stages) == 4 and head[-1] == "output"
        assert shapes[0] == (16, 16, 3) and shapes[-1][-1] == 2048
        entries = ["input"] + [s[-1] for s in stages[:-1]]
        fns = [graph_stage_fn(m, s, e) for s, e in zip(stages, entries)]
        with pytest.raises(ValueError, match="configured input"):
            resnet50_pipeline_plan(m, (32, 32, 3))
        packed, metas = pack_stage_params(
            [{n: m.params[n] for n in s if n in m.params} for s in stages])
        pipe = HeteroPipe(fns, metas, shapes, None, n_microbatches=2)
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=(4, 16, 16, 3)).astype(np.float32))
        with torch.no_grad():
            h = pipe(packed, x)
            y = graph_stage_fn(m, head, stages[-1][-1])(
                {n: m.params[n] for n in head if n in m.params}, h)
            want = m.output(x)
        err = float((y - want).abs().max() / want.abs().max())
        assert err < 1e-5, err


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs the card")
def test_bert_pipeline_replay_on_card_matches_plain():
    """The BERT encoder stack (width 64, 4 heads of 16) replayed as a
    4-stage GPipe on the card, forward and gradients, through the flash
    kernels against the same replay on the plain lowering: within 1e-4 of
    the output's largest |value| and of the gradients' (f32), and the
    flash kernels launched at every tick of every stage."""
    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.common.trees import tree_map
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        TransformerEncoderLayer,
    )
    from deeplearning4j_tpu_torch.ops.cuda import FLASH_FWD
    from deeplearning4j_tpu_torch.parallel import GPipe, stack_stage_params

    torch.backends.cuda.matmul.allow_tf32 = False
    layer = TransformerEncoderLayer(d_model=64, n_heads=4, d_ff=128)
    stages = [layer.init(torch.Generator().manual_seed(s),
                         InputType.recurrent(64, 32), "cuda")[0]
              for s in range(4)]
    stacked = stack_stage_params(stages)
    h = torch.randn(8, 32, 64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    pipe = GPipe(lambda p, x: layer.apply(p, {}, x)[0], None,
                 n_microbatches=4)

    def run():
        s = tree_map(lambda a: a.clone().requires_grad_(True), stacked)
        y = pipe(s, h)
        leaves = list(s.values())
        return [y.detach()] + list(torch.autograd.grad((y * y).sum(),
                                                       leaves))

    FLASH_FWD.launches = 0
    got = run()
    assert FLASH_FWD.launches == 4 * (4 + 3)
    env.disable_kernels = True   # every registry op on its plain lowering
    try:
        want = run()
    finally:
        env.reload()
    assert float((got[0] - want[0]).abs().max()
                 / want[0].abs().max()) < 1e-4
    # the gradients against the largest |value| of them all: a key bias's
    # gradient is 0 in exact arithmetic, noise against its own size
    scale = max(float(b.abs().max()) for b in want[1:])
    assert max(float((a - b).abs().max())
               for a, b in zip(got[1:], want[1:])) / scale < 1e-4
