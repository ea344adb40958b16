"""The port's training UI (``deeplearning4j_tpu_torch/ui/``) against the JAX
package's, on the CPU.

The same 12-iteration run as ``tests/test_ui.py`` goes through both
packages from the same weights (``load_jax_params``): the same records and
keys, the same iterations sampled, scores within ``TOL_SCORE``,
``params_mean_magnitude`` within ``TOL_MAG`` (relative) and the same
histogram bins and counts, ``u`` deltas included. From the same parameters
(no step between) the records are equal: the listener reads the leaves in
``jax.tree_util.tree_leaves``' order (dict keys sorted), so the per-leaf
sums add in the same order and ``params_mean_magnitude`` is the same
float. A ``FileStatsStorage`` file either package writes reads the same in
the other. ``collect_data`` and ``render_report`` give the JAX package's
payload and HTML for the same records, and ``UIServer`` serves its routes
on a loopback port. The ``cuda`` case counts the device-to-host copies of a
sampled iteration on the card: one.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ui as J
import deeplearning4j_tpu.ui.server as jax_server
import deeplearning4j_tpu_torch.ui as T
import deeplearning4j_tpu_torch.ui.server as port_server
from deeplearning4j_tpu.nn import (InputType as JaxInputType,
                                   MultiLayerNetwork as JaxNet,
                                   NeuralNetConfiguration as JaxNNC)
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.optimize import Sgd as JaxSgd
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration, MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.graph import (
    load_jax_params as load_jax_graph_params,
)
from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                    load_jax_params)

TOL_SCORE = 1e-5
TOL_MAG = 1e-6      # relative; the two packages' steps part by f32 rounding
TOL_MINMAX = 1e-6   # a histogram's min and max after the same steps
# the keys a record carries whose values are clocks, not the model's
CLOCK_KEYS = ("timestamp", "iteration_time_ms", "iterations_per_sec",
              "host_rss_mb")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One PyTorch intra-op thread for this file's tests: tier-1 runs six
    workers over the machine's cores, and at the default pool size their
    OpenMP threads oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_net():
    conf = (JaxNNC.builder().seed(5).updater(JaxSgd(lr=0.1)).list()
            .layer(JaxDense(n_out=8, activation="relu"))
            .layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    return JaxNet(conf).init()


def _pair(dtype=None):
    """The JAX net of ``tests/test_ui.py`` and the port's from its weights."""
    jnet = _jax_net()
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    if dtype is not None:
        conf.dtype = dtype
    net = MultiLayerNetwork(conf).init(device="cpu")
    load_jax_params(net, _np(jnet.params))
    return jnet, net


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    return x, y


def _train(P, net, storage, iters=12):
    net.set_listeners(P.StatsListener(storage, session_id="s1",
                                      update_frequency=5))
    x, y = _data()
    for _ in range(iters):
        net.fit_batch((x, y))
    return net


def _both_runs(iters=12):
    jnet, net = _pair()
    js, ps = J.InMemoryStatsStorage(), T.InMemoryStatsStorage()
    _train(J, jnet, js, iters)
    _train(T, net, ps, iters)
    return js.records("s1"), ps.records("s1")


def _hold(got, want, exact=False):
    """One record of the port's against the JAX package's."""
    assert sorted(got) == sorted(want)
    for k in want:
        if k in CLOCK_KEYS:
            continue
        if k == "histograms":
            # a layer's name, not its place: the JAX graph's params dict
            # comes back from its jitted step with the keys sorted, the
            # port's keeps the topological order
            assert sorted(got[k]) == sorted(want[k])
            for layer, entry in want[k].items():
                assert sorted(got[k][layer]) == sorted(entry), layer
                for kind, h in entry.items():
                    g = got[k][layer][kind]
                    assert g["counts"] == h["counts"], (layer, kind)
                    tol = 0.0 if exact else TOL_MINMAX
                    assert abs(g["min"] - h["min"]) <= tol, (layer, kind)
                    assert abs(g["max"] - h["max"]) <= tol, (layer, kind)
        elif k == "score":
            assert abs(got[k] - want[k]) <= (0.0 if exact else TOL_SCORE)
        elif k == "params_mean_magnitude":
            if exact:
                assert got[k] == want[k]
            else:
                assert abs(got[k] - want[k]) <= TOL_MAG * abs(want[k])
        else:
            assert got[k] == want[k], k


def test_exports_equal_the_jax_all():
    assert T.__all__ == J.__all__ and len(T.__all__) == 5


def test_twelve_iterations_agree_with_jax():
    want, got = _both_runs()
    assert len(got) == len(want) == 12
    sampled = [r["iteration"] for r in got if "histograms" in r]
    assert sampled == [r["iteration"] for r in want if "histograms" in r]
    assert sampled == [0, 5, 10]
    for g, w in zip(got, want):
        _hold(g, w)
    # the update histograms (parameter deltas) from the second sample on
    assert all("u" in e for e in got[10]["histograms"].values())
    assert "u" not in got[0]["histograms"]["0_DenseLayer"]


def test_same_params_give_the_same_record():
    """No step between: the record (magnitude, histograms) is JAX's, to the
    bit, the magnitude's per-leaf sums in JAX's leaf order."""
    jnet, net = _pair()
    js, ps = J.InMemoryStatsStorage(), T.InMemoryStatsStorage()
    jl, pl = J.StatsListener(js), T.StatsListener(ps)
    for it in (0, 10):
        jl.iteration_done(jnet, it, 0, 0.5)
        pl.iteration_done(net, it, 0, 0.5)
    for g, w in zip(ps.records(), js.records()):
        _hold(g, w, exact=True)


def _two_input_graph(P):
    from importlib import import_module

    nn = import_module(f"{P}.nn")
    layers = import_module(f"{P}.nn.layers")
    opt = import_module(f"{P}.optimize")
    gconf = import_module(f"{P}.nn.conf.graph")
    g = (nn.NeuralNetConfiguration.builder().seed(3).updater(opt.Sgd(lr=0.1))
         .graph_builder().add_inputs("b", "a")
         .set_input_types(a=nn.InputType.feed_forward(3),
                          b=nn.InputType.feed_forward(2)))
    g.add_layer("zeta", layers.DenseLayer(n_out=5, activation="tanh"), "a")
    g.add_layer("alpha", layers.DenseLayer(n_out=4, activation="relu"), "b")
    g.add_vertex("merge", gconf.MergeVertex(), "zeta", "alpha")
    g.add_layer("out", layers.OutputLayer(n_out=2, activation="softmax",
                                          loss="mcxent"), "merge")
    return g.set_outputs("out").build()


def test_graph_records_agree_with_jax():
    """A ComputationGraph's histograms by vertex name, and the magnitude
    over the vertices in sorted order, as JAX's tree functions walk them."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph

    jnet = JaxGraph(_two_input_graph("deeplearning4j_tpu")).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json())).init(device="cpu")
    load_jax_graph_params(net, _np(jnet.params))
    js, ps = J.InMemoryStatsStorage(), T.InMemoryStatsStorage()
    jl, pl = J.StatsListener(js), T.StatsListener(ps)
    jl.iteration_done(jnet, 0, 0, 0.5)
    pl.iteration_done(net, 0, 0, 0.5)
    _hold(ps.records()[0], js.records()[0], exact=True)
    assert list(ps.records()[0]["histograms"]) == list(jnet.params) == [
        "zeta", "alpha", "out"]

    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 3)).astype(np.float32)
    b = rng.normal(size=(6, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    for n in (jnet, net):
        n.fit_batch(([b, a], [y]))
    jl.iteration_done(jnet, 10, 0, 0.5)
    pl.iteration_done(net, 10, 0, 0.5)
    _hold(ps.records()[1], js.records()[1])


def test_bf16_net_reads_the_f32_params():
    _, net = _pair(dtype="bf16")
    x, y = _data()
    net.fit_batch((x, y))
    st = T.InMemoryStatsStorage()
    T.StatsListener(st).iteration_done(net, 0, 0, 0.5)
    leaves = [p.detach().double().numpy()
              for layer in net.params for _, p in sorted(layer.items())]
    assert all(p.dtype == torch.float32
               for layer in net.params for p in layer.values())
    want = sum(np.abs(a).sum() for a in leaves) / sum(a.size
                                                      for a in leaves)
    assert abs(st.records()[0]["params_mean_magnitude"] - want) <= 1e-6 * want
    total = sum(sum(e["w"]["counts"])
                for e in st.records()[0]["histograms"].values())
    assert total == net.num_params()


def test_non_finite_params_are_dropped_from_histograms():
    jnet, net = _pair()
    net.params[0]["W"][0, 0] = float("nan")
    net.params[1]["b"][:] = float("inf")
    st = T.InMemoryStatsStorage()
    T.StatsListener(st).iteration_done(net, 0, 0, 0.5)
    h = st.records()[0]["histograms"]
    assert sum(h["0_DenseLayer"]["w"]["counts"]) == 4 * 8 + 8 - 1
    assert sum(h["1_OutputLayer"]["w"]["counts"]) == 8 * 3


def test_epoch_end_record_and_listener_options():
    want_recs, got_recs = [], []
    for P, recs in ((J, want_recs), (T, got_recs)):
        pair = _pair()
        net = pair[0] if P is J else pair[1]
        st = P.InMemoryStatsStorage()
        net.set_listeners(P.StatsListener(
            st, update_frequency=2, collect_param_stats=False,
            collect_histograms=False, collect_system_stats=False))
        x, y = _data()
        net.fit(x, y, epochs=3)
        net.listeners[0].on_epoch_end(net, 0)
        recs.extend(st.records())
    assert len(got_recs) == len(want_recs) == 4
    for g, w in zip(got_recs, want_recs):
        _hold(g, w)


# ------------------------------------------------------------------ storage

def test_in_memory_collects_and_sessions():
    _, got = _both_runs()
    st = T.InMemoryStatsStorage()
    for r in got:
        st.put(r)
    st.put({"session": "s2", "iteration": 0, "score": 1.0})
    st.put({"iteration": 0, "score": 2.0})
    assert st.session_ids() == ["default", "s1", "s2"]
    assert len(st.scalars("score", "s1")) == 12
    assert len([r for r in st.records("s1")
                if "params_mean_magnitude" in r]) == 3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_storage_crosses_packages(tmp_path, writer):
    """The listener of one package appends; the other package's storage
    reads the same records, incrementally, as the writer's own does."""
    W, R = (J, T) if writer == "jax" else (T, J)
    jnet, net = _pair()
    path = tmp_path / "stats.jsonl"
    ws, rs = W.FileStatsStorage(path), R.FileStatsStorage(path)
    _train(W, jnet if W is J else net, ws, iters=6)
    assert rs.records() == ws.records() and len(rs.records()) == 6
    model = jnet if W is J else net
    x, y = _data()
    for _ in range(4):
        model.fit_batch((x, y))
    assert rs.records() == ws.records() and len(rs.records()) == 10
    assert rs.records("s1") == W.FileStatsStorage(path).records("s1")
    out_w = ws.export_csv(tmp_path / "w")
    out_r = rs.export_csv(tmp_path / "r")
    assert [p.name for p in out_w] == [p.name for p in out_r]
    for a, b in zip(out_w, out_r):
        assert a.read_text() == b.read_text()


def test_file_storage_incremental_and_truncation(tmp_path):
    for P in (J, T):
        path = tmp_path / f"{P.__name__}.jsonl"
        st = P.FileStatsStorage(path)
        for i in range(5):
            st.put({"iteration": i, "score": float(i)})
        assert len(st.records()) == 5
        for i in range(5, 8):
            st.put({"iteration": i, "score": float(i)})
        assert [r["iteration"] for r in st.records()] == list(range(8))
        # the other package, opened late, sees everything
        other = (T if P is J else J).FileStatsStorage(path)
        assert other.records() == st.records()
        path.write_text(json.dumps({"iteration": 0, "score": 9.0}) + "\n")
        assert [r["score"] for r in st.records()] == [9.0]
        assert [r["score"] for r in other.records()] == [9.0]


def test_file_storage_partial_line_and_rewrite(tmp_path):
    path = tmp_path / "s.jsonl"
    st = T.FileStatsStorage(path)
    st.put({"iteration": 0, "score": 1.0})
    with open(path, "a") as f:
        f.write('{"iteration": 1, "sco')
    assert len(st.records()) == 1
    with open(path, "a") as f:
        f.write('re": 2.0}\n')
    assert [r["iteration"] for r in st.records()] == [0, 1]
    path.write_text(json.dumps({"iteration": 0, "score": 5.0,
                                "extra": "x" * 50}) + "\n"
                    + json.dumps({"iteration": 1, "score": 6.0}) + "\n")
    assert [r["score"] for r in st.records()] == [5.0, 6.0]
    st.put({"iteration": 2, "score": 7.0})
    assert [r["score"] for r in st.records()] == [5.0, 6.0, 7.0]
    assert [r["score"] for r in J.FileStatsStorage(path).records()] == [
        5.0, 6.0, 7.0]


# ----------------------------------------------------------- server, report

def _shared_records():
    """The JAX run's records, with one non-finite score, in a storage of
    each package."""
    want, _ = _both_runs()
    want[3]["score"] = float("nan")
    stores = J.InMemoryStatsStorage(), T.InMemoryStatsStorage()
    for st in stores:
        for r in want:
            st.put(r)
        st.put({"session": "s2", "iteration": 0, "score": 1.0})
    return stores


@pytest.mark.parametrize("points,hist", [(400, 80), (5, 2)])
def test_collect_data_is_the_jax_payload(points, hist):
    js, ps = _shared_records()
    want = jax_server.collect_data([js], max_points=points, max_hist=hist)
    got = port_server.collect_data([ps], max_points=points, max_hist=hist)
    assert json.dumps(got) == json.dumps(want)
    s1 = got["sessions"]["s1"]
    assert len(s1["series"]["score"]) == min(points, 11)
    assert set(s1["histograms"]) == {"0_DenseLayer", "1_OutputLayer"}


def test_render_report_is_the_jax_html():
    js, ps = _shared_records()
    assert port_server.render_report(ps) == jax_server.render_report(js)
    assert (port_server.render_report(ps, "s2")
            == jax_server.render_report(js, "s2"))
    assert port_server._DASHBOARD_HTML == jax_server._DASHBOARD_HTML


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_server_routes_on_a_live_port():
    from deeplearning4j_tpu_torch import monitoring

    _, ps = _shared_records()
    server = T.UIServer(port=0).attach(ps).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        status, ctype, body = _get(base + "/")
        assert status == 200 and "Training dashboard" in body.decode()
        status, ctype, body = _get(base + "/data?points=3&hist=x")
        assert ctype == "application/json"
        assert body == json.dumps(port_server.collect_data(
            [ps], max_points=3)).encode()
        status, _, body = _get(base + "/report")
        assert body.decode() == port_server.render_report(ps)
        status, ctype, body = _get(base + "/metrics")
        assert ctype.startswith("text/plain")
        assert body.decode() == monitoring.metrics_text()
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/nope")
        assert e.value.code == 404
        assert server.port != 0
    finally:
        server.stop()
    empty = T.UIServer(port=0).start()
    try:
        _, _, body = _get(f"http://127.0.0.1:{empty.port}/report")
        assert b"no storage attached" in body
    finally:
        empty.stop()


def test_dashboard_is_live_while_training():
    """``tests/test_ui.py``'s liveness case on the port: a poll after more
    steps sees new records."""
    _, net = _pair()
    st = T.InMemoryStatsStorage()
    _train(T, net, st)
    server = T.UIServer(port=0).attach(st).start()
    try:
        url = f"http://127.0.0.1:{server.port}/data"
        s1 = json.loads(_get(url)[2])["sessions"]["s1"]
        layer0 = next(iter(s1["histograms"].values()))
        assert layer0["iters"] and layer0["w"][0]["counts"]
        assert any(u is not None for u in layer0["u"])
        x, y = _data()
        for _ in range(6):
            net.fit_batch((x, y))
        s2 = json.loads(_get(url)[2])["sessions"]["s1"]
        assert s2["records"] == s1["records"] + 6
        assert len(s2["series"]["score"]) > len(s1["series"]["score"])
    finally:
        server.stop()


def test_system_series_reach_the_payload():
    _, got = _both_runs()
    sampled = [r for r in got if "host_rss_mb" in r]
    assert [r["iteration"] for r in sampled] == [0, 5, 10]
    assert all(r["host_rss_mb"] > 10.0 for r in sampled)
    # a CPU net reports no device memory, as the JAX package's CPU backend
    assert not any("device_mem_in_use_mb" in r for r in got)
    assert all(r["iterations_per_sec"] > 0 for r in got[1:])


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_one_device_to_host_copy_a_sampled_iteration():
    """A sampled iteration copies the whole parameter tree (four leaves
    here) to the host once; an unsampled one copies nothing. The record is
    the CPU net's from the same seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from torch.profiler import ProfilerActivity, profile

    jnet, _ = _pair()
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf).init(device="cuda")
    cpu = MultiLayerNetwork(conf).init(device="cpu")
    listener = T.StatsListener(T.InMemoryStatsStorage(), update_frequency=5)
    torch.cuda.synchronize()

    def copies(it):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            listener.iteration_done(net, it, 0, 0.5)
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if "Memcpy DtoH" in e.name)
    assert copies(0) == 1
    assert copies(1) == 0
    ref = T.InMemoryStatsStorage()
    T.StatsListener(ref).iteration_done(cpu, 0, 0, 0.5)
    got = listener.storage.records()[0]
    want = ref.records()[0]
    assert got["params_mean_magnitude"] == want["params_mean_magnitude"]
    assert got["histograms"] == want["histograms"]
    assert got["device_mem_in_use_mb"] > 0
