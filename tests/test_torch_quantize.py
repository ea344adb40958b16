"""The port's int8 weight-only quantization against the JAX package.

Held against ``deeplearning4j_tpu.quantize`` on the same numpy inputs, in
f32: ``quantize_tensor``'s payload and scales bit for bit (dense and conv
axes, a zero channel); ``quantized_matmul`` and ``quantized_einsum``
(1e-6), with the einsum's refusal of a contracted scale axis;
``QuantizedTensor``'s surface (``@`` through the op, row gather, casts
that move only the scale, a move that moves both, the tree functions);
``quantize()`` of a dense net, a conv net and a graph against the JAX
view's outputs on the same weights (1e-5); the inference view's guard and
its own copies while the original trains; quantized zips both ways; the
witness on predict and on int8-KV decode, and its control; a small
quantized causal LM's int8-KV greedy decode against the JAX
``AttentionDecodeAdapter``; the monitoring bundle's ``observe_pass``.
The JAX witness (``quantize/witness.py``) cannot run on this jax, so the
port's witness is held to its contract on the port's own functions. On
the card (``cuda``) the quantized LM decodes through the captured graph.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.generation.engine import (
    AttentionDecodeAdapter as JaxAdapter,
)
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import (
    ConvolutionLayer as JaxConv, DenseLayer as JaxDense,
    EmbeddingSequenceLayer as JaxEmbSeq, OutputLayer as JaxOut,
    RnnOutputLayer as JaxRnnOut,
)
from deeplearning4j_tpu.nn.layers.attention import (
    PositionalEmbeddingLayer as JaxPosEmb,
    TransformerEncoderLayer as JaxEncoder,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.ops.registry import op as jax_op
from deeplearning4j_tpu.quantize import quantize_tensor as jax_quantize_tensor
from deeplearning4j_tpu.util import serialization as jax_serialization
from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.common.dtypes import cast_floating
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.common.trees import (
    tree_leaves, tree_map, tree_unflatten,
)
from deeplearning4j_tpu_torch.generation import (
    AttentionDecodeAdapter, GenerationEngine,
)
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration, MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_params,
)
from deeplearning4j_tpu_torch.ops.registry import get_op, op
from deeplearning4j_tpu_torch.quantize import (
    QUANT_RULES, QuantizedTensor, assert_no_dequantized_weights,
    dequantize_tensor, find_dequantized_weights, quantize_network,
    quantize_params, quantize_tensor,
)
from deeplearning4j_tpu_torch.util import serialization

V = 13  # the JAX tests' decode vocabulary
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_monitoring():
    """The port's monitoring, armed by a test, is cleared, its variable
    first, before ``env`` reloads (as the observability tests do). The
    JAX package's monitoring is left as it is: a reset there would re-arm
    it from a variable another file leaked."""
    yield
    os.environ.pop("DL4J_TORCH_MONITORING", None)
    env.reload()
    monitoring.reset()


def _params_np(jnet):
    return jax.tree_util.tree_map(np.asarray, jnet.params)


def _port_net(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf).init(device="cpu")
    return load_jax_params(net, _params_np(jnet),
                           jax.tree_util.tree_map(np.asarray, jnet.state))


def _jax_dense(seed=0, n_in=16, hidden=32, n_out=5):
    """tests/test_quantize.py's ``_dense_net``."""
    conf = (JaxNNC.builder().seed(seed).list()
            .layer(JaxDense(n_out=hidden, activation="relu"))
            .layer(JaxOut(n_out=n_out, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(n_in)).build())
    return JaxNet(conf).init()


def _jax_tf(seed=3, D=16, n_layers=2, max_len=32):
    """tests/test_quantize.py's ``_tf_net``."""
    b = JaxNNC.builder().seed(seed).list()
    b = b.layer(JaxEmbSeq(n_out=D, n_in=V))
    b = b.layer(JaxPosEmb(max_len=max_len))
    for _ in range(n_layers):
        b = b.layer(JaxEncoder(d_model=D, n_heads=2, causal=True))
    b = b.layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
    return JaxNet(b.set_input_type(JaxInputType.recurrent(V, 12))
                  .build()).init()


@pytest.fixture(scope="module")
def dense_pair():
    jnet = _jax_dense()
    return jnet, _port_net(jnet)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ the tensor
@pytest.mark.parametrize("shape,axis", [((16, 8), 1), ((16, 8), -1),
                                        ((8, 16), 0), ((3, 3, 2, 4), 3)],
                         ids=["dense", "dense_neg", "rows", "conv"])
def test_quantize_tensor_is_jax_bit_for_bit(shape, axis):
    w = _x(shape, 1) * 3.0
    w[..., 0] = 0.0  # a zero slice: the 1e-12 scale floor
    want = jax_quantize_tensor(jnp.asarray(w), axis)
    got = quantize_tensor(torch.tensor(w), axis)
    assert got.q.dtype == torch.int8 and got.axis == want.axis
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(dequantize_tensor(got).numpy(),
                                  np.asarray(want.dequantize()))
    assert got.nbytes() == want.nbytes()


def test_quantize_tensor_refuses_other_dtypes():
    with pytest.raises(ValueError, match="int4"):
        quantize_tensor(torch.ones(2, 2), dtype="int4")


def test_quantized_ops_match_jax():
    x = _x((2, 3, 16), 2)
    qt = jax_quantize_tensor(jnp.asarray(_x((16, 8), 3)), 1)
    q, s = np.asarray(qt.q), np.asarray(qt.scale)
    want = jax_op("quantized_matmul")(jnp.asarray(x), qt.q, qt.scale)
    got = op("quantized_matmul")(torch.tensor(x), torch.tensor(q),
                                 torch.tensor(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    want = jax_op("quantized_einsum")("btd,dn->btn", jnp.asarray(x), qt.q,
                                      qt.scale)
    got = op("quantized_einsum")("btd,dn->btn", torch.tensor(x),
                                 torch.tensor(q), torch.tensor(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    assert [i.platform for i in get_op("quantized_matmul").impls] == ["plain"]
    assert [i.platform for i in get_op("quantized_einsum").impls] == ["plain"]


def test_quantized_einsum_refuses_a_contracted_scale_axis():
    # the weight's last axis is contracted away: the per-output-channel
    # scale cannot go on the accumulator
    q = torch.zeros((8, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="last axis"):
        op("quantized_einsum")("bd,fd->bf", torch.zeros(2, 16), q,
                               torch.ones(8))
    with pytest.raises(ValueError):
        jax_op("quantized_einsum")("bd,fd->bf", jnp.zeros((2, 16)),
                                   jnp.zeros((8, 16), jnp.int8),
                                   jnp.ones(8))


def test_matmul_operator_routes_through_the_op(monkeypatch):
    qt = quantize_tensor(torch.tensor(_x((16, 8), 4)), 1)
    calls = []
    impl = get_op("quantized_matmul").plain
    fn = impl.fn
    monkeypatch.setattr(impl, "fn", lambda *a: calls.append(1) or fn(*a))
    get_op("quantized_matmul")._choices.clear()
    x = torch.tensor(_x((4, 16), 5))
    y = x @ qt
    assert calls == [1]
    torch.testing.assert_close(y, x @ qt.dequantize(), atol=1e-5, rtol=1e-5)
    with pytest.raises(TypeError):
        torch.matmul(x, qt)  # only the operator defers to __rmatmul__
    conv = quantize_tensor(torch.tensor(_x((3, 3, 2, 4), 6)), 0)
    with pytest.raises(ValueError, match="axis last"):
        torch.ones(2, 3) @ conv


def test_getitem_dequantizes_only_the_rows():
    w = _x((10, 6), 7)
    jt = jax_quantize_tensor(jnp.asarray(w), 1)
    qt = quantize_tensor(torch.tensor(w), 1)
    idx = np.array([[1, 4], [9, 0]])
    got = qt[torch.as_tensor(idx)]
    assert got.shape == (2, 2, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jt[jnp.asarray(idx)]),
                               atol=1e-7)


def test_casts_move_only_the_scale_and_moves_move_both():
    qt = quantize_tensor(torch.tensor(_x((16, 8), 8)), 1)
    for t in (qt.astype(torch.bfloat16), qt.to(torch.bfloat16),
              cast_floating({"W": qt}, torch.bfloat16)["W"]):
        assert t.q is qt.q and t.q.dtype == torch.int8
        assert t.scale.dtype == torch.bfloat16 and t.dtype == torch.bfloat16
    moved = qt.to("meta")
    assert moved.q.device.type == "meta" and moved.scale.device.type == "meta"
    assert moved.q.dtype == torch.int8 and moved.axis == 1
    both = qt.to(device="meta", dtype=torch.bfloat16)
    assert both.device.type == "meta" and both.scale.dtype == torch.bfloat16


def test_tree_functions_see_the_node_children():
    qt = quantize_tensor(torch.tensor(_x((16, 8), 9)), 1)
    tree = [{"W": qt, "b": torch.zeros(8)}]
    leaves = tree_leaves(tree)
    assert leaves[0] is qt.q and leaves[1] is qt.scale and len(leaves) == 3
    doubled = tree_map(lambda a: a * 2 if a.is_floating_point() else a, tree)
    assert isinstance(doubled[0]["W"], QuantizedTensor)
    assert doubled[0]["W"].axis == 1 and doubled[0]["W"].q is qt.q
    torch.testing.assert_close(doubled[0]["W"].scale, qt.scale * 2)
    back = tree_unflatten(tree, leaves)
    assert back[0]["W"].q is qt.q and back[0]["W"].scale is qt.scale


# ------------------------------------------------------------ the pass
def test_rules_are_the_jax_rules():
    from deeplearning4j_tpu.quantize import QUANT_RULES as JAX_RULES

    assert QUANT_RULES == JAX_RULES
    assert "CenterLossOutputLayer" not in QUANT_RULES


def test_unknown_layer_passes_through():
    class FakeLayer:
        pass

    params = {"W": torch.ones(4, 4)}
    out, n = quantize_params(params, FakeLayer())
    assert out is params and n == 0


def test_dense_view_matches_jax(dense_pair):
    jnet, net = dense_pair
    jq, q = jnet.quantize(), net.quantize()
    assert isinstance(q.params[0]["W"], QuantizedTensor)
    assert not isinstance(q.params[0]["b"], QuantizedTensor)
    assert isinstance(q.params[1]["W"], QuantizedTensor)
    assert not isinstance(net.params[0]["W"], QuantizedTensor)
    for a, b in zip(q.params, jq.params):
        for k in a:
            if isinstance(a[k], QuantizedTensor):
                np.testing.assert_array_equal(a[k].q.numpy(),
                                              np.asarray(b[k].q))
    x = _x((64, 16), 9)
    np.testing.assert_allclose(q.output(x).numpy(),
                               np.asarray(jq.output(jnp.asarray(x))), **TOL)
    a, b = net.output(x).numpy(), q.output(x).numpy()
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.97
    assert float(np.abs(a - b).max()) < 0.05
    assert q.quantize() is q


def test_conv_view_matches_jax():
    conf = (JaxNNC.builder().seed(5).list()
            .layer(JaxConv(n_out=4, kernel=(3, 3), activation="relu"))
            .layer(JaxOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(8, 8, 2)).build())
    jnet = JaxNet(conf).init()
    net = _port_net(jnet)
    jq, q = jnet.quantize(), net.quantize()
    w = q.params[0]["W"]
    assert isinstance(w, QuantizedTensor)
    assert w.axis == 3 and tuple(w.scale.shape) == (4,)
    x = _x((4, 8, 8, 2), 18)
    np.testing.assert_allclose(q.output(x).numpy(),
                               np.asarray(jq.output(jnp.asarray(x))), **TOL)
    a, b = net.output(x).numpy(), q.output(x).numpy()
    assert float(np.abs(a - b).max()) < 0.05


def _graph_pair():
    conf = (JaxNNC.builder().seed(0).graph_builder()
            .add_inputs("in")
            .set_input_types(**{"in": JaxInputType.feed_forward(4)})
            .add_layer("d", JaxDense(n_out=8, activation="relu"), "in")
            .add_layer("out", JaxOut(n_out=3, activation="softmax",
                                     loss="mcxent"), "d")
            .set_outputs("out").build())
    jg = JaxGraph(conf).init()
    g = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json())).init(device="cpu")
    load_jax_params(g, _params_np(jg))
    return jg, g


def test_graph_view_matches_jax_and_refuses_training():
    jg, g = _graph_pair()
    jq, q = jg.quantize(), g.quantize()
    assert q._quantized and q.opt_state == {}
    assert isinstance(q.params["d"]["W"], QuantizedTensor)
    x = _x((16, 4), 12)
    np.testing.assert_allclose(q.output(x).numpy(),
                               np.asarray(jq.output(jnp.asarray(x))), **TOL)
    with pytest.raises(RuntimeError, match="inference view"):
        q.fit_batch((x, np.eye(3, dtype=np.float32)[np.zeros(16, int)]))


def test_view_guard_and_the_original_still_trains():
    jnet = _jax_dense(seed=1)
    net = _port_net(jnet)
    q = net.quantize()
    assert q._quantized and q.opt_state == [{} for _ in q.params]
    x = _x((8, 16), 10)
    y = np.eye(5, dtype=np.float32)[np.random.default_rng(11).integers(
        0, 5, 8)]
    with pytest.raises(RuntimeError, match="inference view"):
        q.fit_batch((x, y))
    before = q.output(x).clone()
    state = [{k: v.clone() for k, v in p.items()
              if isinstance(v, torch.Tensor)} for p in q.params]
    for _ in range(3):
        assert np.isfinite(float(net.fit_batch((x, y))))
    # the view owns its leaves: the original's steps leave it as it was
    torch.testing.assert_close(q.output(x), before, atol=0, rtol=0)
    for p, s in zip(q.params, state):
        for k, v in s.items():
            assert torch.equal(p[k], v)
    assert net.params[0]["b"] is not q.params[0]["b"]


def test_regularization_skips_quantized():
    conf = (JaxNNC.builder().seed(2).list()
            .layer(JaxDense(n_out=8, activation="relu", l2=1e-2))
            .layer(JaxOut(n_out=3, activation="softmax", loss="mcxent",
                          l2=1e-2))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    jnet = JaxNet(conf).init()
    net = _port_net(jnet)
    q, jq = net.quantize(), jnet.quantize()
    for i in range(2):
        got = q.layers[i].regularization(q.params[i])
        want = jq.conf.layers[i].regularization(jq.params[i])
        np.testing.assert_allclose(float(got), float(want), atol=1e-7)
    assert float(net.layers[0].regularization(net.params[0])) > 0


# ------------------------------------------------------------ the zips
def test_zip_port_to_jax_and_back(dense_pair, tmp_path):
    jnet, net = dense_pair
    q = net.quantize()
    path = str(tmp_path / "q.zip")
    serialization.write_model(q, path)
    back = jax_serialization.restore_model(path)
    assert back._quantized
    for a, b in zip(q.params, back.params):
        for k in a:
            if isinstance(a[k], QuantizedTensor):
                np.testing.assert_array_equal(a[k].q.numpy(),
                                              np.asarray(b[k].q))
                np.testing.assert_array_equal(a[k].scale.numpy(),
                                              np.asarray(b[k].scale))
                assert a[k].axis == b[k].axis
    x = _x((8, 16), 13)
    np.testing.assert_allclose(np.asarray(back.output(jnp.asarray(x))),
                               q.output(x).numpy(), **TOL)
    again = serialization.restore_model(path, device="cpu")
    assert again._quantized and again.opt_state == [{}, {}]
    torch.testing.assert_close(again.output(x), q.output(x), atol=0, rtol=0)
    with pytest.raises(RuntimeError, match="inference view"):
        again.fit_batch((x, np.zeros((8, 5), np.float32)))


def test_zip_jax_to_port(dense_pair, tmp_path):
    jnet, _ = dense_pair
    jq = jnet.quantize()
    path = str(tmp_path / "jq.zip")
    jax_serialization.write_model(jq, path)
    net = MultiLayerNetwork.load(path, device="cpu")
    assert net._quantized and isinstance(net.params[0]["W"], QuantizedTensor)
    np.testing.assert_array_equal(net.params[0]["W"].q.numpy(),
                                  np.asarray(jq.params[0]["W"].q))
    x = _x((8, 16), 14)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jq.output(jnp.asarray(x))), **TOL)


def test_graph_zip_round_trip(tmp_path):
    jg, g = _graph_pair()
    q = g.quantize()
    path = str(tmp_path / "g.zip")
    q.save(path)
    back = ComputationGraph.load(path, device="cpu")
    assert back._quantized and isinstance(back.params["d"]["W"],
                                          QuantizedTensor)
    x = _x((5, 4), 15)
    torch.testing.assert_close(back.output(x), q.output(x), atol=0, rtol=0)
    jback = jax_serialization.restore_model(path)
    np.testing.assert_allclose(np.asarray(jback.output(jnp.asarray(x))),
                               q.output(x).numpy(), **TOL)


# ------------------------------------------------------------ the witness
def test_witness_passes_on_predict_and_flags_the_control(dense_pair):
    _, net = dense_pair
    q = net.quantize()
    x = torch.tensor(_x((4, 16), 16))
    # the params ride along as an argument: their int8 payloads name the
    # shapes screened for
    predict = lambda x, params: q.output(x)  # noqa: E731
    assert find_dequantized_weights(predict, x, q.params) == []
    assert_no_dequantized_weights(predict, x, q.params)

    def bad(a, w):
        return a @ (w.q.float() * w.scale)

    w = q.params[0]["W"]
    hits = find_dequantized_weights(bad, x, w)
    assert hits and hits[0][1] == tuple(w.shape)
    with pytest.raises(AssertionError, match="dequantized"):
        assert_no_dequantized_weights(bad, x, w)
    # a bare cast at the weight's shape is allowed
    assert find_dequantized_weights(lambda a, w: a @ w.q.float(), x, w) == []


def test_witness_passes_on_conv_predict():
    conf = (JaxNNC.builder().seed(5).list()
            .layer(JaxConv(n_out=4, kernel=(3, 3), activation="relu"))
            .layer(JaxOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(8, 8, 2)).build())
    q = _port_net(JaxNet(conf).init()).quantize()
    assert_no_dequantized_weights(lambda x, params: q.output(x),
                                  torch.tensor(_x((2, 8, 8, 2), 3)), q.params)
    w = q.params[0]["W"]
    assert find_dequantized_weights(lambda: w.dequantize(),
                                    weight_shapes=[w.shape])


@pytest.fixture(scope="module")
def lm_pair():
    jnet = _jax_tf()
    return jnet, _port_net(jnet)


def test_witness_passes_on_int8_kv_decode(lm_pair):
    _, net = lm_pair
    q = net.quantize()
    ad = AttentionDecodeAdapter(q, 16, kv_dtype="int8")
    prompt = torch.as_tensor(np.random.default_rng(17).integers(0, V, (2, 4)))
    caches = ad.prefill(prompt, None)
    for c in caches.values():
        assert len(c) == 4 and c[0].dtype == torch.int8
    tok, pos = prompt[:, -1], torch.full((2,), 3, dtype=torch.long)
    # the weight shapes only: the int8 ring is int8 too, and its
    # requantization multiplies at the ring's shape by design
    wshapes = {tuple(t.q.shape) for p in q.params for t in p.values()
               if isinstance(t, QuantizedTensor)}
    assert len(wshapes) >= 3
    assert_no_dequantized_weights(ad.decode, caches, tok, pos,
                                  weight_shapes=wshapes)
    assert_no_dequantized_weights(ad.prefill, prompt, None,
                                  weight_shapes=wshapes)
    logits, _ = ad.decode(caches, tok, pos)
    assert logits.shape == (2, V) and bool(torch.isfinite(logits).all())


def test_quantized_int8_kv_decode_matches_jax_greedy(lm_pair):
    """The quantized LM, int8 ring, greedy from the same prompt: the
    port's adapter against the JAX ``AttentionDecodeAdapter`` over the
    JAX view (logits 1e-4, the same greedy tokens)."""
    jnet, net = lm_pair
    jq, q = jnet.quantize(), net.quantize()
    B, max_len, T0, steps = 3, 32, 6, 12
    prompt = np.random.default_rng(16).integers(0, V, (B, T0))
    ja = JaxAdapter(jq, max_len, kv_dtype="int8")
    pa = AttentionDecodeAdapter(q, max_len, kv_dtype="int8")
    jc = ja.prefill(jq.params, jq.state, jnp.asarray(prompt), None)
    pc = pa.prefill(torch.as_tensor(prompt), None)
    jtok, ptok = jnp.asarray(prompt[:, -1]), torch.as_tensor(prompt[:, -1])
    jtoks, ptoks = [], []
    for t in range(T0 - 1, T0 - 1 + steps):
        jl, jc = ja.decode(jq.params, jq.state, jc, jtok,
                           jnp.full((B,), t, jnp.int32))
        pl, pc = pa.decode(pc, ptok, torch.full((B,), t, dtype=torch.long))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4, err_msg=f"position {t}")
        jtok, ptok = jnp.argmax(jl, -1), pl.argmax(-1)
        jtoks.append(np.asarray(jtok))
        ptoks.append(ptok.numpy())
    np.testing.assert_array_equal(np.stack(ptoks), np.stack(jtoks))


def test_quantized_engine_serves_on_one_program(lm_pair):
    _, net = lm_pair
    q = net.quantize()
    eng = GenerationEngine(q, slots=4, max_len=24, kv_dtype="int8",
                           device="cpu")
    outs = [eng.generate(list(np.random.default_rng(s).integers(0, V, 5)),
                         max_new_tokens=6, temperature=0.0)
            for s in range(3)]
    for o in outs:
        assert len(o) == 6 and all(0 <= t < V for t in o)
    assert eng.decode_programs == 1


# ------------------------------------------------------------ monitoring
def test_observe_pass_records_the_pass(dense_pair):
    _, net = dense_pair
    monitoring.reset()
    assert monitoring.quantize_monitor() is None
    net.quantize()
    assert not monitoring.enabled()
    monitoring.enable()
    q = quantize_network(net)
    text = monitoring.registry().exposition()
    assert 'dl4j_quantize_passes_total{dtype="int8"} 1' in text
    assert "dl4j_quantize_tensors_total 2" in text
    before = sum(t.numel() * t.element_size() for t in tree_leaves(net.params))
    after = sum(t.numel() * t.element_size() for t in tree_leaves(q.params))
    assert after < before
    assert f"dl4j_quantize_bytes_before {float(before)}" in text or \
        f"dl4j_quantize_bytes_before {before}" in text
    assert f"dl4j_quantize_bytes_after {float(after)}" in text or \
        f"dl4j_quantize_bytes_after {after}" in text


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_quantized_decode_on_card(lm_pair, cuda_device):
    """The quantized LM on the card, int8 ring, through the captured
    graph: the greedy tokens of the CPU engine, one decode program, and
    the witness clean over an eager decode step there."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, net = lm_pair
        q = net.quantize()
        card = quantize_network(net).to(cuda_device)
        assert card.params[2]["Wq"].q.device.type == "cuda"
        prompts = [[1, 2, 3, 4], [5], [7, 7, 0, 12, 3, 9, 1, 2, 11]]
        runs = []
        for m, d in ((q, "cpu"), (card, cuda_device)):
            eng = GenerationEngine(m, slots=2, max_len=32, kv_dtype="int8",
                                   device=d)
            streams = [eng.submit(p, max_new_tokens=8) for p in prompts]
            eng.drain()
            runs.append([s.tokens for s in streams])
        assert runs[0] == runs[1]
        assert eng.decode_programs == 1 and eng.replays == eng.steps_run
        ad = AttentionDecodeAdapter(card, 16, kv_dtype="int8")
        prompt = torch.as_tensor([[1, 2, 3, 4]], device=cuda_device)
        caches = ad.prefill(prompt, None)
        assert_no_dequantized_weights(
            ad.decode, caches, prompt[:, -1],
            torch.full((1,), 3, dtype=torch.long, device=cuda_device),
            weight_shapes={tuple(t.q.shape) for p in card.params
                           for t in p.values()
                           if isinstance(t, QuantizedTensor)})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
