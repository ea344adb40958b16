"""The port's BERT slice against the JAX package, on shared numpy inputs.

``gelu`` and each new layer against its JAX twin (embeddings, positional
embedding, LayerNorm, masked global pooling, the self-attention layers and
the transformer encoder with ``pre_norm`` both ways and causal); then a tiny
``Bert`` (vocab 97, T 16, d_model 32, 2 layers of 2 heads, d_ff 64, 3
classes, dropout 0, f32): the same ``configuration.json``, ``output()``
after ``load_jax_params`` with and without a padding mask, three
``fit_batch`` steps with AdamW on a warmup-cosine schedule and clipping 1.0,
and zips crossing both ways mid-training. Tolerance 1e-5 (relative for
losses, absolute and relative for params and outputs): the two packages
differ only in the order of their sums. On the CPU the port's attention
takes the plain lowering (the JAX package's XLA lowering at these shapes);
every padding mask leaves each example at least one valid key, where the
plain lowering and the flash kernels agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import (
    EmbeddingLayer as JaxEmbedding, EmbeddingSequenceLayer as JaxEmbSeq,
    GlobalPoolingLayer as JaxPool, LayerNormalizationLayer as JaxLN,
    LearnedSelfAttentionLayer as JaxLearnedAttn,
    SelfAttentionLayer as JaxSelfAttn, TransformerEncoderLayer as JaxEncoder,
)
from deeplearning4j_tpu.nn.layers.attention import (
    PositionalEmbeddingLayer as JaxPositional,
)
from deeplearning4j_tpu.ops.activations import get_activation as jax_act
from deeplearning4j_tpu.util.serialization import (
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu.zoo.bert import Bert as JaxBert, BertBase as JaxBertBase
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import Layer, TransformerEncoderLayer
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.zoo import Bert, BertBase

TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(vocab_size=97, max_len=16, d_model=32, n_layers=2, n_heads=2,
            d_ff=64, num_classes=3, dropout=0.0, dtype="float32")
# lr large enough, and the warmup short enough, that 3 steps move the params
TRAIN = dict(TINY, lr=1e-3, warmup=1, total_steps=10)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _assert_trees_close(port, ref, **tol):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _assert_trees_close(port[k], ref[k], **tol)
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _assert_trees_close(a, b, **tol)
    else:
        np.testing.assert_allclose(port.detach().cpu().numpy(),
                                   np.asarray(ref), **(tol or TOL))


def _padding_mask(rng, B, T):
    """[B, T] f32, each row at least one valid position."""
    lens = rng.integers(1, T + 1, B)
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


# ------------------------------------------------------------------ layers

def test_gelu_is_jax_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax_act("gelu")(jnp.asarray(x)))
    got = get_activation("gelu")(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(get_activation("relu")(torch.tensor(x)).numpy(),
                               np.maximum(x, 0))


def _layer_pair(jax_layer, itype, seed=0):
    """The JAX layer's params (from its own init, nudged off zeros and ones)
    and the port's twin built from the JAX layer's JSON."""
    jp, js = jax_layer.init(jax.random.key(seed), JaxInputType(*itype))
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32)
        * 0.05, jp)
    port = Layer.from_dict(jax_layer.to_dict())
    assert type(port).__name__ == type(jax_layer).__name__
    assert port.to_dict() == jax_layer.to_dict()
    p, _ = port.init(torch.Generator().manual_seed(seed), InputType(*itype),
                     "cpu")
    assert jax.tree_util.tree_structure(_np_tree(p)) == \
        jax.tree_util.tree_structure(jp)
    return port, _t_tree(jp), jp, js


ENCODERS = [dict(pre_norm=True), dict(pre_norm=False),
            dict(pre_norm=True, causal=True), dict(pre_norm=False, causal=True)]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("kw", ENCODERS,
                         ids=lambda k: "-".join(f"{a}{b}" for a, b in k.items()))
def test_encoder_matches_jax(kw, masked):
    jl = JaxEncoder(d_model=16, n_heads=4, d_ff=24, **kw)
    port, p, jp, js = _layer_pair(jl, ("rnn", (7, 16)), seed=3)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    m = _padding_mask(rng, 3, 7) if masked else None
    want, _ = jl.apply(jp, js, jnp.asarray(x),
                       mask=None if m is None else jnp.asarray(m))
    got, _ = port.apply(p, {}, torch.tensor(x),
                        mask=None if m is None else torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


LAYERS = [
    pytest.param(JaxEmbSeq(n_out=8, n_in=11), ("rnn", (6, 11)), "ids",
                 id="embedding-sequence"),
    pytest.param(JaxEmbSeq(n_out=8, n_in=11, has_bias=True,
                           activation="tanh"), ("rnn", (6, 11)), "ids1",
                 id="embedding-sequence-bias-3d"),
    pytest.param(JaxEmbedding(n_out=8, n_in=11), ("ff", (11,)), "id",
                 id="embedding"),
    pytest.param(JaxPositional(max_len=9), ("rnn", (6, 8)), "x",
                 id="positional"),
    pytest.param(JaxLN(), ("rnn", (6, 8)), "x", id="layernorm"),
    pytest.param(JaxLN(elementwise_affine=False, eps=1e-3), ("rnn", (6, 8)),
                 "x", id="layernorm-plain"),
    pytest.param(JaxSelfAttn(n_out=8, n_heads=2), ("rnn", (6, 8)), "xm",
                 id="self-attention"),
    pytest.param(JaxLearnedAttn(n_out=8, n_heads=2, n_queries=3),
                 ("rnn", (6, 8)), "xm", id="learned-self-attention"),
] + [pytest.param(JaxPool(pooling_type=pt), ("rnn", (6, 8)), inp,
                  id=f"pool-{pt}-{inp}")
     for pt in ("avg", "max", "sum") for inp in ("x", "xm")] + [
    pytest.param(JaxPool(pooling_type="pnorm"), ("rnn", (6, 8)), "x",
                 id="pool-pnorm"),
    pytest.param(JaxPool(pooling_type="avg"), ("cnn", (3, 4, 5)), "img",
                 id="pool-avg-cnn"),
]


@pytest.mark.parametrize("jax_layer,itype,inp", LAYERS)
def test_layer_matches_jax(jax_layer, itype, inp):
    port, p, jp, js = _layer_pair(jax_layer, itype, seed=5)
    rng = np.random.default_rng(2)
    m = None
    if inp.startswith("id"):
        x = rng.integers(0, 11, (4, 6) if inp == "ids" else
                         ((4, 6, 1) if inp == "ids1" else (4, 1)))
    elif inp == "img":
        x = rng.normal(size=(4, 3, 4, 5)).astype(np.float32)
    else:
        x = rng.normal(size=(4, 6, 8)).astype(np.float32)
        if inp == "xm":
            m = _padding_mask(rng, 4, 6)
    want, _ = jax_layer.apply(jp, js, jnp.asarray(x),
                              mask=None if m is None else jnp.asarray(m))
    got, _ = port.apply(p, {}, torch.tensor(x),
                        mask=None if m is None else torch.tensor(m))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (port.feed_forward_mask(m, None) is None) == \
        (jax_layer.feed_forward_mask(m, None) is None)


def test_encoder_dropout_draws_from_the_generator():
    enc = TransformerEncoderLayer(d_model=8, n_heads=2, dropout_rate=0.5)
    p, _ = enc.init(torch.Generator().manual_seed(0),
                    InputType.recurrent(8, 5), "cpu")
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(1))
    run = lambda seed: enc.apply(p, {}, x, train=True, rng=torch.Generator()
                                 .manual_seed(seed))[0]
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    assert torch.equal(enc.apply(p, {}, x, train=False)[0],
                       enc.apply(p, {}, x, train=True, rng=None)[0])


# -------------------------------------------------------------------- model

def _port_bert(jnet, **kw):
    net = Bert(**kw).init(device="cpu")
    load_jax_params(net, _np_tree(jnet.params))
    return load_jax_opt_state(net, _np_tree(jnet.opt_state), jnet.step_count,
                              jnet.epoch_count)


def _batch(seed, B=6, T=16, V=97, C=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (B, T)).astype(np.int32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    return x, y, _padding_mask(rng, B, T)


@pytest.mark.parametrize("model", [(JaxBert, Bert, TINY),
                                   (JaxBertBase, BertBase, {})],
                         ids=["tiny", "base"])
def test_configuration_json_matches_jax(model):
    jax_cls, port_cls, kw = model
    want = jax_cls(**kw).conf().to_json()
    assert port_cls(**kw).conf().to_json() == want
    assert port_cls().dtype == "bf16" and port_cls().n_layers == 12


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_output_matches_jax(masked):
    jnet = JaxBert(**TINY).init()
    net = _port_bert(jnet, **TINY)
    assert net.num_params() == jnet.num_params()
    x, _, m = _batch(1)
    mask = m if masked else None
    want = jnet.output(jnp.asarray(x),
                       mask=None if mask is None else jnp.asarray(mask))
    got = net.output(x, mask=mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fit_batch_trains_like_jax():
    """3 steps of AdamW + warmup-cosine + clipping 1.0 on padded batches:
    losses, params and updater state agree."""
    jnet = JaxBert(**TRAIN).init()
    net = _port_bert(jnet, **TRAIN)
    before = [a.clone() for a in net.params[3].values()]
    for s in range(3):
        x, y, m = _batch(10 + s)
        want = float(jnet.fit_batch((x, y, m)))
        got = net.fit_batch((x, y, m))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert net.step_count == jnet.step_count == 3
    assert any(not torch.equal(a, b)
               for a, b in zip(net.params[3].values(), before))
    _assert_trees_close(net.params, jnet.params)
    _assert_trees_close(net.opt_state, jnet.opt_state)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_zip_crosses_packages_mid_training(tmp_path, writer):
    jnet = JaxBert(**TRAIN).init()
    net = _port_bert(jnet, **TRAIN)
    for s in range(2):
        x, y, m = _batch(20 + s)
        jnet.fit_batch((x, y, m))
        net.fit_batch((x, y, m))
    path = str(tmp_path / "bert.zip")
    if writer == "port":
        net.save(path)
        jnet = jax_restore(path)
    else:
        jnet.save(path)
        net = MultiLayerNetwork.load(path, device="cpu")
    assert net.step_count == jnet.step_count == 2
    _assert_trees_close(net.params, jnet.params, atol=0, rtol=0)
    _assert_trees_close(net.opt_state, jnet.opt_state, atol=0, rtol=0)
    x, y, m = _batch(22)
    np.testing.assert_allclose(net.fit_batch((x, y, m)),
                               float(jnet.fit_batch((x, y, m))), rtol=1e-5)


def test_bf16_bert_trains_f32_params():
    net = Bert(**dict(TRAIN, dtype="bf16")).init(device="cpu")
    x, y, m = _batch(30)
    out = net.output(x, mask=m)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert np.isfinite(net.fit_batch((x, y, m)))
    assert all(a.dtype == torch.float32 for a in net.params[3].values())


# -------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_bert_on_card_runs_the_flash_kernels(cuda_device):
    """The tiny Bert on the card: 2 forward launches per output(), 2 + 2 +
    2 per fit_batch, and the same output as the CPU's plain path."""
    from deeplearning4j_tpu_torch.ops.cuda import FLASH_DKV, FLASH_DQ, FLASH_FWD

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        net = Bert(**TRAIN).init(device="cpu")
        card = Bert(**TRAIN).init(device=cuda_device)
        load_jax_params(card, [{k: a.numpy() for k, a in p.items()}
                               for p in net.params])
        x, y, m = _batch(40)
        n = [k.launches for k in (FLASH_FWD, FLASH_DQ, FLASH_DKV)]
        got = card.output(x, mask=m)
        torch.cuda.synchronize()
        assert [k.launches for k in (FLASH_FWD, FLASH_DQ, FLASH_DKV)] == \
            [n[0] + 2, n[1], n[2]]
        np.testing.assert_allclose(got.cpu().numpy(),
                                   net.output(x, mask=m).numpy(), atol=1e-4)
        card.fit_batch((x, y, m))
        torch.cuda.synchronize()
        assert [k.launches for k in (FLASH_FWD, FLASH_DQ, FLASH_DKV)] == \
            [n[0] + 4, n[1] + 2, n[2] + 2]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
