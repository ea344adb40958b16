"""The port's SameDiff (``deeplearning4j_tpu_torch/autodiff/samediff.py``)
against the JAX package's, on the CPU.

Every test of ``tests/test_samediff.py`` runs here in both packages: the
same graph is built through each package's own API from the same numpy
inputs, and the port's results are held to the JAX package's within 1e-5
(f32) as well as to the JAX test's own assertions. Then the ``.sdz`` zip
crosses both ways (outputs and gradients, control-flow sub-graphs
included), a tiny SameDiff BERT built in the JAX package from
``chip_smoke.samediff_bert`` runs ``output``, ``grad`` and 3 Adam ``fit``
steps in the port within 1e-5 of the JAX package, and a SameDiff on the
default device raises on this machine, which has no card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JaxSameDiff
from deeplearning4j_tpu.datasets.iterators import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.optimize.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.optimize.updaters import Adam

TOL = dict(rtol=1e-5, atol=1e-5)


class Pkg:
    """One package's SameDiff entry points, so a test builds the same
    graph in both."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.SameDiff = SameDiff if port else JaxSameDiff
        self.Adam = Adam if port else JaxAdam
        self.Iterator = ArrayDataSetIterator if port else JaxArrayIterator

    def create(self, seed=0):
        if self.name == "port":
            return SameDiff.create(seed, device="cpu")
        return JaxSameDiff.create(seed)

    def load(self, path):
        if self.name == "port":
            return SameDiff.load(path, device="cpu")
        return JaxSameDiff.load(path)


PORT, JAX = Pkg("port"), Pkg("jax")


def host(v):
    """A result as numpy (tensors, jax arrays, dicts and lists of them)."""
    if isinstance(v, dict):
        return {k: host(a) for k, a in v.items()}
    if isinstance(v, (list, tuple)):
        return [host(a) for a in v]
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def assert_close(a, b, **tol):
    tol = tol or TOL
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_close(a[k], b[k], **tol)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_close(x, y, **tol)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                   **tol)


def both(run, **tol):
    """``run(pkg)`` in both packages; the port's result within ``tol`` of
    the JAX package's. Returns the port's, as numpy."""
    got, want = host(run(PORT)), host(run(JAX))
    assert_close(got, want, **tol)
    return got


def test_basic_ops_and_sugar():
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)

    def run(p):
        sd = p.create()
        x = sd.placeholder("x", shape=(2, 3))
        y = (x * 2.0 + 1.0) / 4.0 - 0.25
        return y.eval(x=xv)

    np.testing.assert_allclose(both(run), (xv * 2 + 1) / 4 - 0.25, rtol=1e-6)


def test_matmul_reductions():
    av = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)

    def run(p):
        sd = p.create()
        a = sd.placeholder("a", shape=(3, 4))
        b = sd.var("b", np.ones((4, 5), np.float32))
        return (a @ b).sum(axis=1).eval(a=av)

    np.testing.assert_allclose(both(run), (av @ np.ones((4, 5))).sum(1),
                               rtol=1e-5)


def test_wide_op_catalog():
    xv = np.array([0.5, -1.0, 2.0, -0.25], np.float32)

    def run(p):
        sd = p.create()
        x = sd.placeholder("x", shape=(4,))
        vs = [sd.exp(x), sd.gelu(x), sd.norm2(x), sd.normmax(x),
              sd.cumsum(x, axis=0), sd.clip_by_value(x, -0.5, 0.5),
              sd.argmax(x, axis=0)]
        return [v.eval(x=xv) for v in vs]

    got = both(run)
    for g, want in zip(got, [np.exp(xv), None, np.sqrt((xv ** 2).sum()),
                             np.abs(xv).max(), np.cumsum(xv),
                             np.clip(xv, -0.5, 0.5), np.argmax(xv)]):
        if want is not None:
            np.testing.assert_allclose(g, want, rtol=1e-5)


def test_gather_onehot_scatter():
    def run(p):
        sd = p.create()
        table = sd.var("table", np.arange(12, dtype=np.float32).reshape(4, 3))
        ids = sd.placeholder("ids", shape=(2,))
        rows = sd.embedding_lookup(table, ids).eval(
            ids=np.array([2, 0], np.int32))
        oh = sd.one_hot(ids, depth=4).eval(ids=np.array([1, 3], np.int32))
        return [rows, oh]

    rows, oh = both(run)
    np.testing.assert_allclose(rows, np.array([[6, 7, 8], [0, 1, 2]],
                                              np.float32))
    np.testing.assert_allclose(oh, np.eye(4, dtype=np.float32)[[1, 3]])
    assert oh.dtype == np.float32


def test_strided_slice_sugar():
    xv = np.arange(24, dtype=np.float32).reshape(4, 6)

    def run(p):
        sd = p.create()
        x = sd.placeholder("x", shape=(4, 6))
        return x[1:3, ::2].eval(x=xv)

    np.testing.assert_allclose(both(run), xv[1:3, ::2])


def test_grad_matches_numeric():
    w0 = np.array([[0.3, -0.2], [0.1, 0.4]], np.float32)
    xv = np.array([[1.0, 2.0], [-0.5, 0.25]], np.float32)

    def run(p):
        sd = p.create()
        w = sd.var("w", w0)
        x = sd.placeholder("x", shape=(2, 2))
        loss = sd.sum(sd.tanh(x @ w))
        sd.set_loss(loss)
        return sd.grad(loss, x=xv)["w"]

    g = both(run)
    eps = 1e-3
    num = np.zeros_like(w0)
    for i in range(2):
        for j in range(2):
            wp, wm = w0.copy(), w0.copy()
            wp[i, j] += eps
            wm[i, j] -= eps
            num[i, j] = (np.tanh(xv @ wp).sum()
                         - np.tanh(xv @ wm).sum()) / (2 * eps)
    np.testing.assert_allclose(g, num, atol=1e-3)


def test_fit_linear_regression_converges():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    true_w = np.array([[1.5], [-2.0], [0.5]], np.float32)
    Y = X @ true_w

    def run(p):
        sd = p.create()
        x = sd.placeholder("x", shape=(None, 3))
        y = sd.placeholder("y", shape=(None, 1))
        w = sd.var("w", np.zeros((3, 1), np.float32))
        sd.set_loss(sd.mse(y, x @ w))
        loss = sd.fit(updater=p.Adam(lr=0.05), steps=400, x=X, y=Y)
        return [np.float32(loss), sd.variables()["w"]]

    loss, w = both(run)
    assert loss < 1e-2
    np.testing.assert_allclose(w, true_w, atol=0.15)


def test_fit_iterator():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(32, 2)).astype(np.float32)
    Y = X @ np.array([[1.0], [2.0]], np.float32)

    def run(p):
        it = p.Iterator(X, Y, batch_size=8)
        sd = p.create()
        x = sd.placeholder("x")
        y = sd.placeholder("y")
        w = sd.var("w", np.zeros((2, 1), np.float32))
        sd.set_loss(sd.mse(y, x @ w))
        loss = sd.fit_iterator(it, "x", "y", updater=p.Adam(lr=0.05),
                               epochs=60)
        return [np.float32(loss), sd.variables()["w"]]

    loss, _ = both(run)
    assert loss < 5e-2


def _branches(p):
    tg = p.create()
    tg.mul(tg.placeholder("arg0"), 2.0, name="out")
    fg = p.create()
    fg.mul(fg.placeholder("arg0"), -1.0, name="out")
    return tg, fg


def test_cond_control_flow():
    def run(p):
        tg, fg = _branches(p)
        sd = p.create()
        out = sd.cond(sd.placeholder("p"), tg, fg, [sd.placeholder("x")])
        return [out.eval(p=np.array(v), x=np.float32(3.0))
                for v in (True, False)]

    assert [float(v) for v in both(run)] == [6.0, -3.0]


def _doubling(p):
    # doubles x until it exceeds 100
    cg = p.create()
    cg.lt(cg.placeholder("arg0"), 100.0, name="out")
    bg = p.create()
    bg.mul(bg.placeholder("arg0"), 2.0, name="out")
    return cg, bg


def test_while_loop():
    def run(p):
        cg, bg = _doubling(p)
        sd = p.create()
        return sd.while_loop(cg, bg, [sd.placeholder("x")]).eval(
            x=np.float32(3.0))

    assert float(both(run)) == 192.0


def test_save_load_roundtrip(tmp_path):
    xv = np.random.default_rng(4).normal(size=(2, 3)).astype(np.float32)

    def run(p):
        sd = p.create()
        x = sd.placeholder("x", shape=(2, 3))
        w = sd.var("w", np.random.default_rng(3).normal(size=(3, 4))
                   .astype(np.float32))
        out = sd.softmax(x @ w, name="probs")
        want = out.eval(x=xv)
        path = str(tmp_path / f"model_{p.name}.sdz")
        sd.save(path)
        return [want, p.load(path).output("probs", x=xv)]

    want, got = both(run)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_save_load_then_train(tmp_path):
    X = np.random.default_rng(5).normal(size=(16, 2)).astype(np.float32)
    Y = X @ np.array([[0.5], [1.0]], np.float32)

    def run(p):
        sd = p.create()
        x = sd.placeholder("x")
        y = sd.placeholder("y")
        w = sd.var("w", np.zeros((2, 1), np.float32))
        sd.set_loss(sd.mse(y, x @ w))
        path = str(tmp_path / f"m_{p.name}.sdz")
        sd.save(path)
        sd2 = p.load(path)
        return np.float32(sd2.fit(updater=p.Adam(lr=0.05), steps=300, x=X,
                                  y=Y))

    assert both(run) < 1e-2


def test_summary():
    for p in (PORT, JAX):
        sd = p.create()
        sd.relu(sd.placeholder("x"), name="r")
        s = sd.summary()
        assert "placeholder" in s and "relu" in s
    assert PORT.create().summary() == JAX.create().summary()


def test_negative_integer_index():
    xv = np.arange(5, dtype=np.float32)
    mv = np.arange(12, dtype=np.float32).reshape(3, 4)

    def run(p):
        sd = p.create()
        x = sd.placeholder("x")
        m = sd.placeholder("m")
        return [x[-1].eval(x=xv), x[2].eval(x=xv), m[-1].eval(m=mv),
                m[1, 1:3].eval(m=mv)]

    last, two, mrow, mslice = both(run)
    assert float(last) == 4.0 and float(two) == 2.0
    np.testing.assert_allclose(mrow, mv[-1])
    np.testing.assert_allclose(mslice, mv[1, 1:3])


def test_cond_with_subgraph_constant_roundtrip(tmp_path):
    # branch bodies that auto-create constant nodes must survive save/load
    def run(p):
        tg = p.create()
        tg.add(tg.placeholder("arg0"), 1.0, name="out")
        fg = p.create()
        fg.sub(fg.placeholder("arg0"), np.float32(2.0), name="out")
        sd = p.create()
        sd.cond(sd.placeholder("p"), tg, fg, [sd.placeholder("x")],
                name="out")
        path = str(tmp_path / f"c_{p.name}.sdz")
        sd.save(path)
        sd2 = p.load(path)
        return [sd2.output("out", p=np.array(v), x=np.float32(5.0))
                for v in (True, False)]

    assert [float(v) for v in both(run)] == [6.0, 3.0]


def test_while_subgraph_dtype_preserved_roundtrip(tmp_path):
    def run(p):
        cg = p.create()
        cg.lt(cg.placeholder("arg0"), 10.0, name="out")
        bg = p.create()
        b = bg.placeholder("arg0")
        step = bg.var("step", np.float32(3.0))  # f32 variable in the body
        bg.add(b, step, name="out")
        sd = p.create()
        sd.while_loop(cg, bg, [sd.placeholder("x")], name="out")
        path = str(tmp_path / f"w_{p.name}.sdz")
        sd.save(path)
        return p.load(path).output("out", x=np.float32(1.0))

    got = both(run)
    assert float(got) == 10.0 and got.dtype == np.float32


def test_reversed_slice():
    xv = np.arange(5, dtype=np.float32)

    def run(p):
        sd = p.create()
        x = sd.placeholder("x")
        return [x[::-1].eval(x=xv), x[3:0:-1].eval(x=xv)]

    rev, part = both(run)
    np.testing.assert_allclose(rev, xv[::-1])
    np.testing.assert_allclose(part, xv[3:0:-1])


def _fib_graphs(p):
    cg = p.create()
    cg.placeholder("arg0")
    cg.placeholder("arg1")
    cg.lt(cg.placeholder("arg2"), 5.0, name="out")
    bg = p.create()
    a = bg.placeholder("arg0")
    b = bg.placeholder("arg1")
    j = bg.placeholder("arg2")
    bg.identity(b, name="out0")
    bg.add(a, b, name="out1")
    bg.add(j, 1.0, name="out2")
    return cg, bg


def test_while_loop_multi_carry():
    # Fibonacci-ish: (a, b, i) -> (b, a+b, i+1) while i < 5
    feeds = dict(x=np.float32(0.0), y=np.float32(1.0), n=np.float32(0.0))

    def run(p):
        cg, bg = _fib_graphs(p)
        sd = p.create()
        outs = sd.while_loop(cg, bg, [sd.placeholder(n) for n in "xyn"])
        assert len(outs) == 3
        doubled = sd.mul(outs[1], 2.0)
        return [o.eval(**feeds) for o in outs] + [doubled.eval(**feeds)]

    a_f, b_f, i_f, d = (float(v) for v in both(run))
    assert (a_f, b_f, i_f) == (5.0, 8.0, 5.0) and d == 16.0


def test_parametric_activations():
    from deeplearning4j_tpu.ops.activations import (
        get_activation as jax_activation,
    )
    from deeplearning4j_tpu_torch.ops.activations import get_activation

    x = np.array([-2.0, -0.5, 0.5, 8.0], np.float32)
    for spec, want in (("leakyrelu:0.3", np.where(x > 0, x, 0.3 * x)),
                       ("relumax:6.0", np.clip(x, 0, 6))):
        got = get_activation(spec)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(got, np.asarray(jax_activation(spec)(x)),
                                   **TOL)
    with pytest.raises(ValueError):
        get_activation("softmax:2.0")


def _rnn_scan(p):
    bg = p.create()
    h = bg.placeholder("carry")
    x = bg.placeholder("x")
    a = bg.var("a", np.float32(0.5))
    bg.tanh(bg.add(bg.mul(h, a), x), name="carry_out")
    bg.identity(bg.getVariable("carry_out"), name="y")
    sd = p.create()
    final, ys = sd.scan(bg, sd.placeholder("h0"), sd.placeholder("xs"),
                        name="rnn")
    return sd, final, ys


def test_scan_cumulative_rnn(tmp_path):
    """scan: h' = tanh(h*a + x), with the save/load round trip."""
    xv = np.array([0.1, -0.2, 0.3, 0.4], np.float32)
    feeds = dict(h0=np.float32(0.0), xs=xv)

    def run(p):
        sd, final, ys = _rnn_scan(p)
        path = str(tmp_path / f"scan_{p.name}.sdz")
        sd.save(path)
        return [final.eval(**feeds), ys.eval(**feeds),
                p.load(path).output("rnn_ys", **feeds)]

    got_final, got_ys, reloaded = both(run)
    hh, ref = 0.0, []
    for t in range(4):
        hh = np.tanh(hh * 0.5 + xv[t])
        ref.append(hh)
    np.testing.assert_allclose(got_ys, np.asarray(ref, np.float32), rtol=1e-5)
    assert abs(float(got_final) - ref[-1]) < 1e-5
    np.testing.assert_allclose(reloaded, np.asarray(ref, np.float32),
                               rtol=1e-5)


def test_scan_gradient():
    xv = np.array([1.0, 2.0, 3.0], np.float32)

    def run(p):
        bg = p.create()
        bg.add(bg.placeholder("carry"), bg.placeholder("x"), name="carry_out")
        sd = p.create()
        h0 = sd.placeholder("h0")
        w = sd.var("w", np.float32(2.0))
        final, _ = sd.scan(bg, sd.mul(h0, w), sd.placeholder("xs"))
        sd.set_loss(sd.square(final))
        return sd.grad(sd.square(final), h0=np.float32(1.0), xs=xv)["w"]

    # final = w*1 + 6; d(final^2)/dw = 2*(w+6)*1 = 16
    assert abs(float(both(run)) - 16.0) < 1e-4


def _consts_scan(p):
    bg = p.create()
    h = bg.placeholder("carry")
    x = bg.placeholder("x")
    w = bg.placeholder("const0")
    bg.add(bg.mul(h, w), x, name="carry_out")
    sd = p.create()
    wv = sd.var("w", np.float32(0.5))
    final, _ = sd.scan(bg, sd.placeholder("h0"), sd.placeholder("xs"),
                       consts=[wv])
    sd.set_loss(sd.square(final))
    return sd, final


def test_scan_trainable_weight_via_consts():
    """The weight lives in the OUTER graph and enters the body via consts,
    so grad() and fit() see it."""
    xv = np.array([1.0, 1.0], np.float32)

    def run(p):
        sd, final = _consts_scan(p)
        g = sd.grad(sd.square(final), h0=np.float32(1.0), xs=xv)["w"]
        loss = sd.fit(updater=p.Adam(lr=0.05), steps=50, h0=np.float32(1.0),
                      xs=xv)
        return [g, np.float32(loss), sd.variables()["w"]]

    # final(w) = w^2 + w + 1 at h0 = 1; d(final^2)/dw at w = 0.5 is 7
    g, loss, _ = both(run)
    assert abs(float(g) - 7.0) < 1e-4
    assert loss < 1.75 ** 2


# ------------------------------------------------------- .sdz, both ways

def _control_flow_graph(p):
    """One graph with a cond, a multi-carry while and a consts scan, the
    variables feeding the cond and the scan (JAX cannot take reverse-mode
    gradients through a while loop), and a scalar loss over all three."""
    tg = p.create()
    tg.mul(tg.placeholder("arg0"), tg.placeholder("arg1"), name="out")
    fg = p.create()
    fg.sub(fg.placeholder("arg0"), fg.placeholder("arg1"), name="out")
    cg, bg = _fib_graphs(p)
    sb = p.create()
    sb.tanh(sb.add(sb.mul(sb.placeholder("carry"), sb.placeholder("const0")),
                   sb.placeholder("x")), name="carry_out")
    sd = p.create()
    x = sd.placeholder("x")
    w = sd.var("w", np.float32(0.7))
    v = sd.var("v", np.array([0.3, -0.4, 0.9], np.float32))
    c = sd.cond(sd.placeholder("p"), tg, fg, [x, w], name="c")
    fib = sd.while_loop(cg, bg, [x, sd.mul(x, 2.0),
                                 sd.constant(np.float32(0))], name="fib")
    final, ys = sd.scan(sb, sd.mul(x, w), v, consts=[w], name="rnn")
    total = sd.add(sd.add(sd.square(c), fib[1]),
                   sd.add(final, sd.sum(ys)), name="total")
    sd.set_loss(total)
    return sd


def _graph_results(sd, feeds):
    return [sd.output("total", **feeds), sd.output("rnn_ys", **feeds),
            sd.grad("total", **feeds)]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sdz_crosses_packages_with_control_flow(tmp_path, direction):
    src, dst = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    sd = _control_flow_graph(src)
    path = str(tmp_path / "cf.sdz")
    sd.save(path)
    loaded = dst.load(path)
    for pv in (True, False):
        feeds = dict(x=np.float32(1.3), p=np.array(pv))
        want = host(_graph_results(sd, feeds))
        got = host(_graph_results(loaded, feeds))
        assert_close(got, want)
        assert_close(got, host(_graph_results(_control_flow_graph(dst),
                                              feeds)))


def test_sdz_crossing_keeps_dtypes_and_names(tmp_path):
    sd = JAX.create()
    sd.var("w", np.ones((2, 2), np.float32))
    sd.constant(np.arange(3, dtype=np.int32), name="ids")
    sd.cast(sd.placeholder("x"), "bfloat16", name="xb")
    path = str(tmp_path / "d.sdz")
    sd.save(path)
    port = PORT.load(path)
    assert list(port._nodes) == list(sd._nodes)
    assert port.variables()["w"].dtype == torch.float32
    assert port._nodes["ids"].value.dtype == torch.int32
    assert port.output("xb", x=np.ones(2, np.float32)).dtype == torch.bfloat16
    back = str(tmp_path / "back.sdz")
    port.save(back)
    assert list(JAX.load(back)._nodes) == list(sd._nodes)


def test_bf16_variables_round_trip_in_the_port(tmp_path):
    sd = PORT.create()
    w = sd.var("w", torch.tensor([[1.5, -2.25], [0.125, 3.0]],
                                 dtype=torch.bfloat16))
    sd.mul(sd.placeholder("x"), w, name="y")
    path = str(tmp_path / "bf.sdz")
    sd.save(path)
    back = PORT.load(path)
    assert back.variables()["w"].dtype == torch.bfloat16
    assert torch.equal(back.variables()["w"], sd.variables()["w"])


def test_set_variables_takes_numpy():
    sd = PORT.create()
    sd.var("w", np.zeros(3, np.float32))
    sd.set_variables({"w": np.arange(3, dtype=np.float64)})
    w = sd.variables()["w"]
    assert isinstance(w, torch.Tensor) and w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), [0.0, 1.0, 2.0])


# ---------------------------------------------- a tiny SameDiff BERT

LR = 1e-3

def _tiny_bert():
    """Params of a 2-layer, d 32, 4-head BERT classifier in the port's
    BertBase layout (chip_smoke.samediff_bert reads it), random from a
    seed, and a batch."""
    from deeplearning4j_tpu_torch.zoo import Bert

    model = Bert(seed=3, vocab_size=50, max_len=16, d_model=32, n_layers=2,
                 n_heads=4, d_ff=64, dtype="float32", dropout=0.0)
    net = model.init(device="cpu")
    params = [{k: v.numpy() for k, v in p.items()} for p in net.params]
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 50, (4, 16)).astype(np.int32)
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
    return model, net, params, ids, labels


def _jax_grad(jsd, feeds):
    """What the JAX package's ``grad`` returns (jax.grad of the graph's
    function at its variables), jitted: its ``grad`` differentiates the
    jitted graph eagerly, twice the time on this small BERT."""
    import jax
    import jax.numpy as jnp

    fn = jsd._build_fn(["loss"])
    ph = {k: jnp.asarray(v) for k, v in feeds.items()}
    return host(jax.jit(jax.grad(lambda vs: fn(vs, ph)[0]))(jsd.variables()))


def test_tiny_samediff_bert_jax_built_runs_in_the_port(tmp_path):
    model, net, params, ids, labels = _tiny_bert()
    jsd = chip_smoke.samediff_bert(JaxSameDiff.create(), params,
                                   heads=model.n_heads)
    path = str(tmp_path / "bert.sdz")
    jsd.save(path)
    psd = PORT.load(path)
    feeds = dict(ids=ids, labels=labels)

    assert_close(host(psd.output("probs", **feeds)),
                 host(jsd.output("probs", **feeds)))
    # the graph is the port's own BertBase: probs against net.output()
    assert_close(host(psd.output("probs", **feeds)),
                 net.output(ids).numpy())
    assert_close(host(psd.grad("loss", **feeds)), _jax_grad(jsd, feeds))
    losses = []
    for sd, adam in ((psd, Adam), (jsd, JaxAdam)):
        rec = chip_smoke._Losses()
        sd.fit(updater=adam(lr=LR), steps=3, listeners=[rec], **feeds)
        losses.append(rec.losses)
    assert_close(losses[0], losses[1])
    got, want = host(psd.variables()), host(jsd.variables())
    # the key bias's gradient is 0 in exact arithmetic (softmax ignores a
    # shift of a query's scores): both packages' values are rounding noise,
    # which Adam scales to steps of up to lr either way
    grads = host(psd.grad("loss", **feeds))
    for k in got:
        if k.endswith("_bk"):
            assert np.abs(grads[k]).max() < 1e-5
            assert np.abs(got[k] - want[k]).max() <= 2 * 3 * LR
        else:
            assert_close(got[k], want[k])
    assert_close(host(psd.output("loss", **feeds)),
                 host(jsd.output("loss", **feeds)))


def test_samediff_bert_builder_matches_in_both_packages():
    model, _, params, ids, labels = _tiny_bert()
    sds = [chip_smoke.samediff_bert(p.create(), params, heads=model.n_heads)
           for p in (PORT, JAX)]
    assert list(sds[0]._nodes) == list(sds[1]._nodes)
    got, want = (host(sd.output("probs", "loss", ids=ids, labels=labels))
                 for sd in sds)
    assert_close(got, want)


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("the card is present: SameDiff() takes it")
    with pytest.raises(RuntimeError, match="cuda"):
        SameDiff()
    with pytest.raises(RuntimeError, match="cuda"):
        SameDiff.create()
    sd = SameDiff.create(device="cpu")
    sd.var("w", np.ones(2, np.float32))


def test_load_on_the_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card is present: load() takes it")
    sd = PORT.create()
    sd.var("w", np.ones(2, np.float32))
    path = str(tmp_path / "w.sdz")
    sd.save(path)
    with pytest.raises(RuntimeError, match="cuda"):
        SameDiff.load(path)
