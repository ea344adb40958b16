"""The port's importers on the committed real-framework fixtures, against
their recorded goldens and against the JAX package's importers.

- ``bert_tiny.onnx`` (a transformers BertModel exported by torch.onnx):
  both outputs against ``bert_golden.npz`` within 1e-4 (the JAX test's
  tolerance) and against the JAX importer within 1e-5; ``as_trainable``
  against the JAX package's through 3 Adam steps (params within 1e-5);
  ``compute_dtype=bfloat16`` (the pooler within 3e-2 of the golden, the
  JAX test's bound); ``torch.func.vmap`` over an outer batch of 3 against
  3 separate calls.
- ``tf_small_cnn.pb`` node by node; ``ctrl_flow_v2.pb`` (functional
  StatelessIf / StatelessWhile) and ``switch_merge.pb`` (TF1 Switch /
  Merge); ``quant_graph.pb`` (the three FakeQuant ops, and their
  straight-through gradients against the JAX custom_vjp);
  ``saved_model_cnn`` (SavedModel with a variables bundle): each at the
  JAX test's tolerance.
- Control flow runs eagerly: a predicate under a torch.func transform
  raises, naming the node.
- Entry points default to the card and raise without one. The ``cuda``
  tests put ``bert_tiny.onnx`` on the card by default and run chip_smoke
  phase 25's graph through the LRN kernels.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu.modelimport.onnx import OnnxModelImport as JaxOnnx
from deeplearning4j_tpu.modelimport.tensorflow import TFGraphMapper as JaxTF
from deeplearning4j_tpu.optimize.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.modelimport import OnnxModelImport, TFGraphMapper
from deeplearning4j_tpu_torch.optimize.updaters import Adam

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _fx(name):
    return os.path.join(FIXTURES, name)


@pytest.fixture(scope="module")
def golden():
    return np.load(_fx("bert_golden.npz"))


@pytest.fixture(scope="module")
def bert_tiny():
    return OnnxModelImport.import_model(_fx("bert_tiny.onnx"), device="cpu")


@pytest.fixture(scope="module")
def jax_bert_tiny():
    return JaxOnnx.import_model(_fx("bert_tiny.onnx"))


def _feeds(g):
    return {"input_ids": g["ids"], "attention_mask": g["mask"]}


def test_bert_tiny_outputs(golden, bert_tiny, jax_bert_tiny):
    outs = ["last_hidden_state", "pooler_output"]
    lh, po = bert_tiny.output(_feeds(golden), outputs=outs)
    jlh, jpo = jax_bert_tiny.output(_feeds(golden), outputs=outs)
    assert po.shape == golden["pooler"].shape  # rank-0 Gather index
    np.testing.assert_allclose(lh.numpy(), golden["last_hidden"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(po.numpy(), golden["pooler"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lh.numpy(), np.asarray(jlh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(po.numpy(), np.asarray(jpo), rtol=1e-5,
                               atol=1e-5)


def test_bert_tiny_adam_steps_match_jax(golden, bert_tiny, jax_bert_tiny):
    """3 Adam steps on the pooler's squared distance to a target, both
    packages from the imported weights: params within 1e-5."""
    import jax

    feeds = _feeds(golden)
    target = np.sign(golden["pooler"]).astype(np.float32)
    lr = 1e-3
    fn, params = bert_tiny.as_trainable(outputs=["pooler_output"])
    upd = Adam(lr=lr)
    state = upd.init_state(params)
    tt = torch.as_tensor(target)
    for i in range(3):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = ((fn(p, feeds) - tt) ** 2).mean()
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        with torch.no_grad():
            u, state = upd.update(g, state, params, i)
            params = {k: params[k] - u[k] for k in params}

    jfn, jparams = jax_bert_tiny.as_trainable(outputs=["pooler_output"])
    assert set(jparams) == set(params)
    jupd = JaxAdam(lr=lr)
    jstate = jupd.init_state(jparams)
    grad = jax.jit(jax.grad(lambda p: ((jfn(p, feeds) - target) ** 2).mean()))
    for i in range(3):
        u, jstate = jupd.update(grad(jparams), jstate, jparams, i)
        jparams = jax.tree_util.tree_map(lambda a, b: a - b, jparams, u)
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_bert_tiny_bf16_compute(golden, bert_tiny):
    fn, params = bert_tiny.as_trainable(outputs=["pooler_output"],
                                        compute_dtype=torch.bfloat16)
    bf = {k: v.to(torch.bfloat16).requires_grad_() for k, v in params.items()}
    out = fn(bf, _feeds(golden))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(), golden["pooler"],
                               atol=3e-2)
    grads = torch.autograd.grad(out.float().sum(), list(bf.values()))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
    fn32, p32 = bert_tiny.as_trainable(outputs=["pooler_output"])
    np.testing.assert_allclose(fn32(p32, _feeds(golden)).numpy(),
                               golden["pooler"], atol=1e-5)


def test_bert_tiny_vmap_over_outer_batch(golden, bert_tiny):
    """torch.func.vmap over 3 outer batches of the fixture's static [2, 16]
    equals 3 separate calls (bench.py's bert_import lane, at 3)."""
    fn, params = bert_tiny.as_trainable(outputs=["pooler_output"])
    ids = np.stack([golden["ids"], (golden["ids"] + 7) % 500,
                    (golden["ids"] * 3) % 500])
    mask = np.stack([golden["mask"]] * 3)
    mask[1, :, 12:] = 0
    feeds = {"input_ids": torch.as_tensor(ids),
             "attention_mask": torch.as_tensor(mask)}
    batched = torch.func.vmap(lambda f: fn(params, f))(feeds)
    single = torch.stack([fn(params, {k: v[i] for k, v in feeds.items()})
                          for i in range(3)])
    assert batched.shape == (3, 2, 64)
    np.testing.assert_allclose(batched.detach().numpy(),
                               single.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_tf_small_cnn_node_by_node():
    g = np.load(_fx("tf_small_cnn_golden.npz"))
    imp = TFGraphMapper.import_graph(_fx("tf_small_cnn.pb"), device="cpu")
    jimp = JaxTF.import_graph(_fx("tf_small_cnn.pb"))
    probe = [str(p) for p in g["probe"]]
    feeds = {str(g["placeholder"]): g["x"]}
    outs = imp.output(feeds, outputs=probe)
    jouts = jimp.output(feeds, outputs=probe)
    for i, (name, got, jgot) in enumerate(zip(probe, outs, jouts)):
        want = g[f"node_{i}"]
        scale = float(np.max(np.abs(want))) + 1e-9
        err = float(np.max(np.abs(got.numpy() - want)))
        assert err / scale < 1e-4, f"node {name}: rel err {err / scale:.2e}"
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_tf_frozen_cnn_sgd_steps_match_jax():
    import jax

    g = np.load(_fx("tf_small_cnn_golden.npz"))
    ph = str(g["placeholder"])
    probe = [str(p) for p in g["probe"]]
    softmax = [n for n in probe if "softmax" in n.lower()][-1]
    fn, params = TFGraphMapper.import_graph(
        _fx("tf_small_cnn.pb"), device="cpu").as_trainable(outputs=[softmax])
    jfn, jparams = JaxTF.import_graph(_fx("tf_small_cnn.pb")).as_trainable(
        outputs=[softmax])
    assert set(params) == set(jparams) and params
    labels = np.eye(fn(params, {ph: g["x"]}).shape[-1],
                    dtype=np.float32)[[0, 1]]

    def loss(pred, lab, log, maximum):
        return -(lab * log(maximum(pred, 1e-7))).sum(-1).mean()

    losses = []
    for _ in range(3):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        lv = loss(fn(p, {ph: g["x"]}), torch.as_tensor(labels), torch.log,
                  lambda a, m: torch.clamp(a, min=m))
        gr = torch.autograd.grad(lv, list(p.values()))
        params = {k: (v - 0.05 * d).detach() for (k, v), d in zip(p.items(),
                                                                 gr)}
        losses.append(float(lv.detach()))
    jgrad = jax.jit(jax.value_and_grad(lambda p: loss(
        jfn(p, {ph: g["x"]}), labels, jax.numpy.log, jax.numpy.maximum)))
    jlosses = []
    for _ in range(3):
        lv, gr = jgrad(jparams)
        jparams = jax.tree_util.tree_map(lambda a, b: a - 0.05 * b, jparams,
                                         gr)
        jlosses.append(float(lv))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_functional_control_flow():
    g = np.load(_fx("ctrl_golden.npz"))
    imp = TFGraphMapper.import_graph(_fx("ctrl_flow_v2.pb"), device="cpu")
    assert imp.functions
    ph = imp.placeholders[0]
    for sign, want in [(1, g["want_pos"]), (-1, g["want_neg"])]:
        out = imp.output({ph: sign * np.abs(g["x"])})
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_control_flow_predicate_under_transform_raises():
    g = np.load(_fx("ctrl_golden.npz"))
    imp = TFGraphMapper.import_graph(_fx("ctrl_flow_v2.pb"), device="cpu")
    ph = imp.placeholders[0]
    x = torch.as_tensor(np.stack([np.abs(g["x"])] * 2))
    with pytest.raises(NotImplementedError, match="predicate") as e:
        torch.func.vmap(lambda a: imp.output({ph: a}))(x)
    assert "If" in str(e.value) or "While" in str(e.value)


def test_tf1_switch_merge():
    g = np.load(_fx("switch_golden.npz"))
    imp = TFGraphMapper.import_graph(_fx("switch_merge.pb"), device="cpu")
    out = imp.output({"x": g["x"]}, outputs=["out"])
    np.testing.assert_allclose(out.numpy(), g["want"], rtol=1e-6, atol=1e-6)


def test_fake_quant_graph_node_by_node():
    g = np.load(_fx("quant_golden.npz"))
    imp = TFGraphMapper.import_graph(_fx("quant_graph.pb"), device="cpu")
    outs = imp.output({"input": g["x"]}, ["wq", "hq", "output", "pc"])
    for name, got in zip(["wq", "hq", "out", "pc"], outs):
        np.testing.assert_allclose(got.numpy(), g[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_fake_quant_gradients_match_jax():
    """The three FakeQuant ops' straight-through gradients (through the
    weights and the min/max inputs the graph holds as constants)."""
    import jax

    g = np.load(_fx("quant_golden.npz"))
    imp = TFGraphMapper.import_graph(_fx("quant_graph.pb"), device="cpu")
    jimp = JaxTF.import_graph(_fx("quant_graph.pb"))
    names = [k for k, v in imp.constants.items()
             if np.issubdtype(v.dtype, np.floating)]
    fn, params = imp.as_trainable(outputs=["pc"], trainable=names)
    jfn, jparams = jimp.as_trainable(outputs=["pc"], trainable=names)
    p = {k: v.requires_grad_() for k, v in params.items()}
    out = fn(p, {"input": g["x"]})
    grads = dict(zip(p, torch.autograd.grad((out * out).sum(),
                                            list(p.values()))))
    jgrads = jax.grad(lambda q: (jfn(q, {"input": g["x"]}) ** 2).sum())(
        jparams)
    assert any(float(v.abs().sum()) > 0 for v in grads.values())
    for k in names:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_saved_model_parity_and_signature():
    g = np.load(_fx("saved_model_cnn_golden.npz"))
    imp = TFGraphMapper.import_saved_model(_fx("saved_model_cnn"),
                                           device="cpu")
    assert imp.signature["inputs"] == {"input": "input:0"}
    assert set(imp.variables) == {"conv/w", "conv/b", "dense/w", "dense/b"}
    out = imp.run_signature({"input": g["x"]})
    np.testing.assert_allclose(out["output"].numpy(), g["y"], rtol=1e-4,
                               atol=1e-5)


def test_bundle_reader_matches_jax():
    from deeplearning4j_tpu.modelimport.tf_bundle import \
        read_variables as jax_read
    from deeplearning4j_tpu_torch.modelimport.tf_bundle import (
        read_index, read_variables,
    )

    prefix = _fx("saved_model_cnn") + "/variables/variables"
    vs, jvs = read_variables(prefix), jax_read(prefix)
    assert sorted(vs) == sorted(jvs)
    for k in vs:
        assert vs[k].dtype == jvs[k].dtype
        np.testing.assert_array_equal(vs[k], jvs[k])
    assert vs["conv/w"].shape == (3, 3, 3, 4)
    np.testing.assert_allclose(vs["dense/b"], np.full(5, 0.1, np.float32))
    assert b"conv/w" in read_index(prefix + ".index")


def test_saved_model_fine_tune_surface():
    import jax

    g = np.load(_fx("saved_model_cnn_golden.npz"))
    imp = TFGraphMapper.import_saved_model(_fx("saved_model_cnn"),
                                           device="cpu")
    fn, params = imp.as_trainable(outputs=["output"])
    assert set(params) == {"conv/w", "conv/b", "dense/w", "dense/b"}
    p = {k: v.requires_grad_() for k, v in params.items()}
    grads = dict(zip(p, torch.autograd.grad(
        (fn(p, {"input": g["x"]}) ** 2).sum(), list(p.values()))))
    jfn, jparams = JaxTF.import_saved_model(
        _fx("saved_model_cnn")).as_trainable(outputs=["output"])
    jgrads = jax.grad(lambda q: (jfn(q, {"input": g["x"]}) ** 2).sum())(
        jparams)
    for k, v in grads.items():
        assert float(v.abs().sum()) > 0
        np.testing.assert_allclose(v.numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_entry_points_default_to_the_card(monkeypatch):
    """No device argument means the card; without one, import raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        OnnxModelImport.import_model(_fx("bert_tiny.onnx"))
    with pytest.raises(RuntimeError, match="cuda"):
        TFGraphMapper.import_graph(_fx("switch_merge.pb"))
    with pytest.raises(RuntimeError, match="cuda"):
        TFGraphMapper.import_saved_model(_fx("saved_model_cnn"))


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_import_model_puts_the_graph_on_the_card(cuda_device, golden):
    imp = OnnxModelImport.import_model(_fx("bert_tiny.onnx"))
    assert imp.device.type == "cuda"
    assert all(t.is_cuda for _, t in imp._device_cache.values())
    lh, po = imp.output(_feeds(golden),
                        outputs=["last_hidden_state", "pooler_output"])
    assert lh.is_cuda and po.is_cuda
    np.testing.assert_allclose(po.cpu().numpy(), golden["pooler"], rtol=1e-4,
                               atol=1e-4)
    fn, params = imp.as_trainable(outputs=["pooler_output"])
    assert all(v.is_cuda for v in params.values())


@pytest.mark.cuda
def test_imported_lrn_launches_the_lrn_kernels(cuda_device):
    from deeplearning4j_tpu_torch.ops.convolution import lrn as plain_lrn
    from deeplearning4j_tpu_torch.ops.cuda import LRN_BWD, LRN_FWD

    shape = (2, 9, 9, 96)
    x = torch.randn(shape, device=cuda_device) * 2
    imp = TFGraphMapper.import_graph(chip_smoke.lrn_graph_def(shape))
    LRN_FWD.launches = LRN_BWD.launches = 0
    y = imp.output({"x": x}, ["lrn"])
    torch.cuda.synchronize()
    assert (LRN_FWD.launches, LRN_BWD.launches) == (1, 0)
    want = plain_lrn(x, depth=5, k=2.0, alpha=1e-4, beta=0.75)
    torch.testing.assert_close(y, want, rtol=2e-5, atol=2e-6)
    conv = TFGraphMapper.import_graph(chip_smoke.lrn_graph_def(shape,
                                                               conv=True))
    fn, params = conv.as_trainable(outputs=["lrn"])
    p = {k: v.requires_grad_() for k, v in params.items()}
    LRN_FWD.launches = LRN_BWD.launches = 0
    torch.autograd.grad(fn(p, {"x": x}).sum(), list(p.values()))
    torch.cuda.synchronize()
    assert (LRN_FWD.launches, LRN_BWD.launches) == (1, 1)
