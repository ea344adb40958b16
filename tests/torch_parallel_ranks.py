"""Rank bodies of the ``tests/test_torch_parallel_*.py`` worlds.

Each function runs in every rank of a gloo world that
``deeplearning4j_tpu_torch.parallel.launch.run`` spawns, with the default
process group joined, and returns numpy results for the test's asserts.
This module imports torch and the port only (a spawned rank imports it by
name, so JAX stays out of the ranks).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.common.trees import tree_map
from deeplearning4j_tpu_torch.parallel import collectives as C
from deeplearning4j_tpu_torch.parallel import (
    DeviceMesh, EncodedGradientTrainer, ParallelWrapper,
    ParameterAveragingTrainer, TensorParallel, init_moe_params,
    multi_slice_mesh, place_moe_params, ring_attention,
    ring_attention_zigzag, sequence_parallel_encoder, switch_moe,
    ulysses_attention, zigzag_shard, zigzag_unshard,
)


def np_tree(tree):
    return tree_map(lambda a: a.detach().cpu().numpy()
                    if isinstance(a, torch.Tensor) else a, tree)


def _raises(fn, *a, **kw):
    """The exception type's name and message fn raised, or None."""
    try:
        fn(*a, **kw)
    except Exception as e:  # the test asserts on what was raised
        return type(e).__name__, str(e)
    return None


# --------------------------------------------------------------- launcher

def raising_rank(rank):
    if rank == 1:
        raise ValueError("rank one failed")
    dist.barrier()  # never completes: the caller kills this rank
    return rank


def hanging_rank(rank):
    if rank == 0:
        time.sleep(600)
    return rank


# ------------------------------------------------------------------- mesh

def mesh_world(rank):
    """Shapes, errors, batch slices and the collectives of a world of 4."""
    out = {"default": DeviceMesh(device="cpu").shape,
           "data2_model2": DeviceMesh(data=2, model=2, device="cpu").shape,
           "model2": DeviceMesh(model=2, device="cpu").shape,
           "bad_shape": _raises(DeviceMesh, data=3, device="cpu"),
           "bad_rest": _raises(DeviceMesh, model=3, device="cpu"),
           "cuda": _raises(DeviceMesh, device="cuda")}
    m = DeviceMesh(data=2, seq=2, device="cpu")
    out["index"] = (m.index("data"), m.index("seq"), m.n_devices)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    out["shard"] = np_tree(m.shard_batch((x, x[:, 0])))
    out["shard_bad"] = _raises(m.shard_batch, x[:7])
    ms = multi_slice_mesh(2, device="cpu")
    out["slices"] = (tuple(ms.mesh_dim_names), tuple(ms.mesh.shape),
                     C.axis_index(ms, "dcn"), C.axis_index(ms, "data"))
    out["slices_bad"] = _raises(multi_slice_mesh, 3, device="cpu")
    g = m.group("data")
    t = torch.arange(4.0, requires_grad=True)
    y = C.psum(t * (rank + 1), g)
    y.sum().backward()
    out["psum"] = (y.detach().numpy(), t.grad.numpy())
    t = torch.arange(4.0, requires_grad=True)
    y = C.all_gather(t * (rank + 1), g, 0)
    (y * torch.arange(8.0)).sum().backward()
    out["all_gather"] = (y.detach().numpy(), t.grad.numpy())
    t = torch.arange(4.0, requires_grad=True)
    y = C.shard(t, g, 0)
    (y * (rank + 1)).sum().backward()
    out["shard_grad"] = (y.detach().numpy(), t.grad.numpy())
    t = (torch.arange(4.0) + 10 * rank).requires_grad_(True)
    y = C.all_to_all(t, g, 0, 0)
    (y * torch.arange(4.0)).sum().backward()
    out["all_to_all"] = (y.detach().numpy(), t.grad.numpy())
    t = torch.tensor([float(rank)], requires_grad=True)
    y = C.rotate(t, g)
    (y * (rank + 1)).sum().backward()
    out["rotate"] = (y.detach().numpy(), t.grad.numpy())
    return out


# ----------------------------------------------------------- data parallel

def _port_net(case, device="cpu"):
    """The port's network of ``case`` (its JSON, the JAX package's params,
    state and updater state as numpy), f64 when ``case["f64"]``."""
    from deeplearning4j_tpu_torch.common.dtypes import DtypePolicy
    from deeplearning4j_tpu_torch.nn.conf.builders import (
        ComputationGraphConfiguration, MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import (
        MultiLayerNetwork, load_jax_opt_state, load_jax_params,
    )

    if case["kind"] == "graph":
        net = ComputationGraph(
            ComputationGraphConfiguration.from_json(case["json"]))
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            case["json"]))
    net.init(device=device)
    load_jax_params(net, case["params"], case.get("state"))
    if case.get("opt") is not None:
        load_jax_opt_state(net, case["opt"])
    if case.get("f64"):
        d = lambda t: tree_map(lambda a: a.double(), t)  # noqa: E731
        net.params, net.state, net.opt_state = (
            d(net.params), d(net.state), d(net.opt_state))
        net._policy = DtypePolicy(torch.float64, torch.float64,
                                  torch.float64)
    return net


class _LocalStats:
    """A data axis whose BatchNorm statistics are each rank's own: the
    control a test expects to disagree with the JAX package."""

    def __init__(self, axis):
        self.axis = axis

    def stats(self, t):
        return t

    def __getattr__(self, name):
        return getattr(self.axis, name)


def data_world(rank, cases):
    """Each case's network through ``ParallelWrapper`` over every rank on
    "data": the per-step losses, and params, state and updater state."""
    out = {}
    for name, case in cases.items():
        net = _port_net(case)
        w = ParallelWrapper(net, DeviceMesh(device="cpu"), prefetch_buffer=0)
        if case.get("control"):
            w.axis = _LocalStats(w.axis)
        if case.get("fit"):
            from deeplearning4j_tpu_torch.datasets.iterators import (
                ArrayDataSetIterator,
            )

            w.prefetch_buffer = 2
            w.fit(ArrayDataSetIterator(*case["batch"],
                                       batch_size=case["fit"]),
                  epochs=case["steps"])
            losses = [net.epoch_count, float(net.score_value)]
        else:
            losses = [float(w.fit_batch(case["batch"]))
                      for _ in range(case["steps"])]
        out[name] = (losses, np_tree(net.params), np_tree(net.state),
                     np_tree(net.opt_state))
    return out


# ------------------------------------------------------------- sequence

def _grads(fn, *xs, do=None):
    """(fn(*xs), the gradients of sum(fn * do) for each x) as numpy."""
    ts = [torch.as_tensor(x).clone().requires_grad_(True) for x in xs]
    out = fn(*ts)
    w = torch.ones_like(out) if do is None else torch.as_tensor(do)
    grads = torch.autograd.grad((out * w).sum(), ts, allow_unused=True)
    return out.detach().numpy(), [None if g is None else g.numpy()
                                  for g in grads]


def sequence_world(rank, p):
    """Ring (both cores, causal or not, masked), Ulysses, the encoder and
    the zig-zag ring over a (data 1, seq 4) mesh, forward and gradients;
    the flash ring's blocks against its one-device replay."""
    mesh = DeviceMesh(data=1, seq=WORLD_SEQ, device="cpu")
    out = {}
    q, k, v, do = p["qkvd"]
    for impl in ("einsum", "flash"):
        for causal in (False, True):
            for masked in (False, True):
                m = p["mask"] if masked else None
                out[("ring", impl, causal, masked)] = _grads(
                    lambda a, b, c: ring_attention(
                        a, b, c, mesh, causal=causal, impl=impl, mask=m),
                    q, k, v, do=do)
    out["ring_local"] = ring_attention(
        *(torch.as_tensor(t).chunk(WORLD_SEQ, 2)[rank] for t in (q, k, v)),
        mesh, causal=True, impl="flash", local=True).numpy()
    out["ring_long"] = ring_attention(
        *(torch.as_tensor(t) for t in p["long"]), mesh, causal=True).numpy()
    out["ring_bad_mask"] = _raises(ring_attention, *(torch.as_tensor(t)
                                   for t in (q, k, v)), mesh,
                                   mask=torch.ones(2, 2, 32, 32))
    out["flash_bad_dim"] = _raises(ring_attention, *(torch.zeros(
        1, 2, 32, 256) for _ in range(3)), mesh, impl="flash")
    qh, kh, vh = p["heads"]
    for causal in (False, True):
        out[("ulysses", causal)] = _grads(
            lambda a, b, c: ulysses_attention(a, b, c, mesh, causal=causal),
            qh, kh, vh)
    out["ulysses_bad_heads"] = _raises(ulysses_attention, *(torch.zeros(
        1, 2, 32, 4) for _ in range(3)), mesh)
    enc_p = {kk: torch.as_tensor(vv) for kk, vv in p["enc_params"].items()}
    for impl, causal, x in (("ring", True, p["enc_x"]),
                            ("ulysses", True, p["enc_x"]),
                            ("ring", False, p["enc_x"]),
                            ("zigzag", True, p["enc_xz"])):
        names = list(enc_p)
        leaves = [enc_p[n].clone().requires_grad_(True) for n in names]
        y = sequence_parallel_encoder(
            dict(zip(names, leaves)), torch.as_tensor(x), mesh,
            n_heads=p["enc_heads"], causal=causal, impl=impl)
        grads = torch.autograd.grad((y * y).sum(), leaves)
        out[("encoder", impl, causal)] = (
            y.detach().numpy(), {n: g.numpy() for n, g in zip(names, grads)})
    out["encoder_zigzag_noncausal"] = _raises(
        sequence_parallel_encoder, enc_p, torch.as_tensor(p["enc_xz"]), mesh,
        n_heads=p["enc_heads"], causal=False, impl="zigzag")
    out["zigzag"] = _grads(lambda a, b, c: ring_attention_zigzag(
        a, b, c, mesh), q, k, v, do=do)
    sh = lambda t: zigzag_shard(torch.as_tensor(t), mesh,  # noqa: E731
                                seq_axis=2)
    out["zigzag_pre"] = zigzag_unshard(ring_attention_zigzag(
        sh(q), sh(k), sh(v), mesh, pre_permuted=True), mesh,
        seq_axis=2).numpy()
    out["zigzag_roundtrip"] = zigzag_unshard(
        sh(p["long"][0]), mesh, seq_axis=2).numpy()
    out["zigzag_bad_T"] = _raises(ring_attention_zigzag, *(torch.zeros(
        1, 1, 36, 8) for _ in range(3)), mesh)
    out["zigzag_bad_dim"] = _raises(ring_attention_zigzag, *(torch.zeros(
        1, 1, 32, 256) for _ in range(3)), mesh)
    return out


WORLD_SEQ = 4


# ------------------------------------------------------- tensor and expert

def _whole(tp):
    """A TensorParallel model's params gathered whole from the shards."""
    g = tp.mesh.group("model")
    dims, params = tp._dims, tp.model.params

    def walk(p, d):
        if isinstance(p, dict):
            return {k: walk(p[k], d[k]) for k in p}
        return p if d is None else C.all_gather(p.detach(), g, d)

    keys = list(params) if isinstance(params, dict) else range(len(params))
    out = {k: walk(params[k], dims[k]) for k in keys}
    return np_tree(out if isinstance(params, dict) else list(out.values()))


def tensor_world(rank, p):
    """TensorParallel runs over a (data 2, model 2) mesh, and the switch
    MoE over (model 4)."""
    out = {}
    for name, case in p["tp"].items():
        net = _port_net(case)
        tp = TensorParallel(net, DeviceMesh(data=2, model=2, device="cpu"))
        specs = tp.param_specs()
        losses = [float(tp.fit_batch(case["batch"]))
                  for _ in range(case["steps"])]
        wrapped = tp._wrapped
        if isinstance(wrapped, dict):
            wrapped = {k: getattr(v, "layer", v) for k, v in wrapped.items()}
        else:
            wrapped = dict(enumerate(wrapped))
        out[name] = (losses, _whole(tp), specs,
                     tp.output(case["batch"][0]).numpy(),
                     {k: (type(getattr(l, "_layer", l)).__name__,
                          getattr(l, "_megatron", None))
                      for k, l in wrapped.items()})
    mesh = DeviceMesh(model=WORLD_SEQ, device="cpu")
    moe = p["moe"]
    placed = place_moe_params(moe["params"], mesh)
    out["moe_shapes"] = {k: tuple(v.shape) for k, v in placed.items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in placed.items()}
    x = torch.as_tensor(moe["x"]).requires_grad_(True)
    y, aux = switch_moe(leaves, x, mesh=mesh)
    w = torch.as_tensor(moe["w"])
    gr = torch.autograd.grad((y * w).sum() + aux, [x] + list(leaves.values()))
    out["moe"] = (y.detach().numpy(), float(aux), gr[0].numpy(),
                  {k: g.numpy() for k, g in zip(leaves, gr[1:])})
    tr = p["moe_train"]
    params = {k: v.clone() for k, v in place_moe_params(
        tr["params"], mesh).items()}
    xt = torch.as_tensor(tr["x"])
    target = torch.as_tensor(tr["y"])
    losses = []
    for _ in range(tr["steps"]):
        ps = {k: v.requires_grad_(True) for k, v in params.items()}
        yy, a = switch_moe(ps, xt, mesh=mesh)
        loss = ((yy + xt - target) ** 2).mean() + 0.01 * a
        grads = torch.autograd.grad(loss, list(ps.values()))
        params = {k: (v - 0.05 * g).detach()
                  for (k, v), g in zip(ps.items(), grads)}
        losses.append(float(loss))
    out["moe_train"] = losses
    gen = init_moe_params(torch.Generator().manual_seed(0), 8, 16, 4,
                          device="cpu")
    out["moe_init"] = {k: tuple(v.shape) for k, v in gen.items()}
    return out


# ------------------------------------------------- encoded and local SGD

def _mse(params, x, y):
    return ((x @ params["w"] - y) ** 2).mean()


def _tuple_loss(params, x, y):
    w1, w2 = params["layers"]
    h = torch.tanh(x @ w1.float())
    return ((h @ w2 - y) ** 2).mean()


def _run_encoded(trainer, params, x, y, steps):
    carry = trainer.init(params)
    losses = []
    for _ in range(steps):
        carry, loss = trainer.fit_batch(carry, x, y)
        losses.append(float(loss))
    return carry, losses


def _round_trajectory(tr, carry, x, y, rounds, **kw):
    losses = []
    for _ in range(rounds):
        carry, loss = tr.fit_round(carry, x, y, **kw)
        losses.append(float(loss))
    return carry, losses


def local_sgd_world(rank, p):
    """EncodedGradientTrainer (flat over "data" and hierarchical over a
    multi-slice mesh) and ParameterAveragingTrainer runs in a world of 4."""
    from deeplearning4j_tpu_torch.optimize.updaters import Adam, Sgd

    out = {}
    flat = DeviceMesh(data=WORLD_SEQ, device="cpu")
    e = p["encoded"]
    w0 = {"w": torch.zeros((4, 1))}
    make = lambda: EncodedGradientTrainer(  # noqa: E731
        _mse, Sgd(lr=0.3), flat, threshold=5e-3, adaptive=False)
    carry, _ = _run_encoded(make(), w0, e["x"], e["y"], e["early"])
    early = (carry["params"]["w"].numpy(), carry["residual"]["w"].numpy())
    carry, losses = _run_encoded(make(), w0, e["x"], e["y"], e["steps"])
    out["encoded"] = (losses, carry["params"]["w"].numpy(), early)
    carry, _ = _run_encoded(EncodedGradientTrainer(
        _mse, Sgd(lr=0.01), flat, threshold=1e-6, target_density=0.25),
        {"w": torch.zeros((16, 1))}, e["ax"], e["ay"], 50)
    out["adaptive_thr"] = float(carry["thr"])
    carry, losses = _run_encoded(EncodedGradientTrainer(
        _tuple_loss, Sgd(lr=0.05), flat, threshold=5e-3, adaptive=False),
        {"layers": (torch.zeros((3, 4), dtype=torch.bfloat16),
                    torch.zeros((4, 1)))}, e["tx"], e["ty"], 5)
    w1, w2 = carry["params"]["layers"]
    out["tuple_bf16"] = (str(w1.dtype), str(w2.dtype),
                         str(carry["residual"]["layers"][0].dtype),
                         losses[-1])
    out["sgd_only"] = _raises(EncodedGradientTrainer, _mse, Adam(lr=0.1),
                              flat)
    ms = multi_slice_mesh(2, device="cpu")
    carry, losses = _run_encoded(EncodedGradientTrainer(
        _mse, Sgd(lr=0.3), ms, axis="dcn", ici_axis="data", threshold=5e-3,
        adaptive=False), w0, e["x"], e["y"], e["steps"])
    out["hier"] = (losses, carry["params"]["w"].numpy())
    one = multi_slice_mesh(WORLD_SEQ, device="cpu")
    ch, _ = _run_encoded(EncodedGradientTrainer(
        _mse, Sgd(lr=0.1), one, axis="dcn", ici_axis="data", threshold=1e-3,
        adaptive=False), w0, e["hx"], e["hy"], 20)
    cf, _ = _run_encoded(EncodedGradientTrainer(
        _mse, Sgd(lr=0.1), flat, threshold=1e-3, adaptive=False), w0,
        e["hx"], e["hy"], 20)
    out["hier_one_slice"] = (ch["params"]["w"].numpy(),
                             cf["params"]["w"].numpy())

    a = p["averaging"]
    for name, upd, k, rounds in (("adam_k4", Adam(lr=0.05), 4, 60),
                                 ("sgd_k1", Sgd(lr=0.1), 1, 10),
                                 ("sgd_k4", Sgd(lr=0.1), 4, 3)):
        tr = ParameterAveragingTrainer(_mse, upd, flat,
                                       averaging_frequency=k)
        carry, losses = _round_trajectory(
            tr, tr.init({"w": torch.zeros((6, 1))}),
            a["x"] if k == 4 else a["x"][:64],
            a["y"] if k == 4 else a["y"][:64], rounds)
        out[name] = (losses, tr.params(carry)["w"].numpy())
    tr = ParameterAveragingTrainer(_mse, Sgd(lr=0.1), flat,
                                   averaging_frequency=2)
    carry, losses = _round_trajectory(
        tr, tr.init({"w": torch.zeros((6, 1))}), a["x"][:128],
        a["y"][:128], 3, lost=[1])
    out["lost"] = (losses, tr.params(carry)["w"].numpy())
    out["lost_all"] = _raises(tr.fit_round, carry, a["x"][:128],
                              a["y"][:128], lost=[0, 1, 2, 3])

    s = p["masked"]
    for name, k, n, extra in (("k1", 1, 64, {}), ("k4", 4, 256, {}),
                              ("mlm", 4, 64, {"label_mask": s["lmask"]}),
                              ("mlm_garbage", 4, 64,
                               {"label_mask": s["lmask"],
                                "y": s["y_garbage"]})):
        net = _port_net(s["net"])
        loss_fn, (p0, s0) = net.as_loss_fn(train=True)
        tr = ParameterAveragingTrainer(loss_fn, Sgd(lr=0.05), flat,
                                       averaging_frequency=k, stateful=True)
        carry = tr.init(p0, state=s0, rng=0)
        y = extra.get("y", s["y"])[:n]
        kw = {"label_mask": extra["label_mask"][:n]} if extra else {}
        carry, losses = _round_trajectory(tr, carry, s["x"][:n], y, 3 if
                                          k == 1 else 1,
                                          mask=s["mask"][:n], **kw)
        out[("masked", name)] = (losses, np_tree(tr.params(carry)))
    out["unmasked_stateless"] = _raises(
        ParameterAveragingTrainer(_mse, Sgd(lr=0.1), flat).fit_round,
        {"w": torch.zeros((6, 1))}, a["x"][:64], a["y"][:64],
        mask=np.ones((64, 1), np.float32))
    return out


# --------------------------------------------------------------- pipeline

def _t(tree):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)


def stage_dense(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def stage_dense_nobias(p, x):
    return torch.tanh(x @ p["W"])


def _value_and_grads(fn, tree):
    """(fn(tree), the gradients of sum(fn(tree) ** 2) for every leaf of
    ``tree``) as numpy."""
    from deeplearning4j_tpu_torch.common.trees import tree_leaves as leaves_of
    from deeplearning4j_tpu_torch.common.trees import tree_unflatten

    leaves = [a.clone().requires_grad_(True) for a in leaves_of(tree)]
    y = fn(tree_unflatten(tree, leaves))
    grads = torch.autograd.grad((y * y).sum(), leaves)
    return y.detach().numpy(), np_tree(tree_unflatten(tree, list(grads)))


class _DropRotation:
    """The control: ``collectives.rotate`` with the call ``at`` replaced by
    zeros (one rotation dropped)."""

    def __init__(self, at):
        self.at, self.calls = at, 0
        self.rotate = C.rotate

    def __enter__(self):
        def rotate(x, group, shift=1):
            self.calls += 1
            if self.calls == self.at:
                return self.rotate(torch.zeros_like(x), group, shift)
            return self.rotate(x, group, shift)

        C.rotate = rotate
        return self

    def __exit__(self, *exc):
        C.rotate = self.rotate


def _bert_stage(case):
    """The port's encoder block of a Bert built from the JAX package's
    configuration JSON, as a stage function."""
    from deeplearning4j_tpu_torch.nn.conf.builders import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        TransformerEncoderLayer,
    )

    conf = MultiLayerConfiguration.from_json(case["json"])
    enc = next(l for l in conf.layers
               if isinstance(l, TransformerEncoderLayer))
    return lambda p, h: enc.apply(p, {}, h, train=False)[0]


def _hetero_fns(n):
    return [stage_dense if s % 2 == 0 else stage_dense_nobias
            for s in range(n)]


def _pipelines(p, mesh):
    """Every pipeline case of ``pipeline_world`` on ``mesh`` (None: the
    one-device replay)."""
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import (
        GPipe, HeteroPipe, pack_stage_params, pipeline_train_step,
    )

    out = {}
    g = p["gpipe"]
    pipe = GPipe(stage_dense, mesh, n_microbatches=4)
    x = torch.as_tensor(g["x"])
    out["gpipe"] = _value_and_grads(lambda s: pipe(s, x), _t(g["stacked"]))
    tr = p["train"]
    step = pipeline_train_step(
        GPipe(stage_dense, mesh, n_microbatches=4),
        lambda pred, y: ((pred - y) ** 2).mean(), Sgd(lr=0.2),
        lambda hp, h: h @ hp["W"])
    params = _t(tr["params"])
    opt = Sgd(lr=0.2).init_state(params)
    losses = []
    for i in range(tr["steps"]):
        params, opt, loss = step(params, opt, i, torch.as_tensor(tr["x"]),
                                 torch.as_tensor(tr["y"]))
        losses.append(float(loss))
    out["train"] = (losses, np_tree(params))
    b = p["bert"]
    bpipe = GPipe(_bert_stage(b), mesh, n_microbatches=4)
    h = torch.as_tensor(b["h"])
    out["bert"] = _value_and_grads(lambda s: bpipe(s, h), _t(b["stacked"]))
    hp = p["hetero"]
    packed, metas = pack_stage_params(_t(hp["stages"]))
    hpipe = HeteroPipe(_hetero_fns(4), metas, hp["shapes"], mesh,
                       n_microbatches=2)
    xh = torch.as_tensor(hp["x"])
    out["hetero_packed"] = packed.numpy()
    out["hetero"] = _value_and_grads(lambda q: hpipe(q, xh), packed)
    out["hetero_sequential"] = _value_and_grads(
        lambda q: hpipe.sequential_reference(q, xh), packed)
    return out


def pipeline_world(rank, p):
    """GPipe (dense stages, a train step, the BERT encoder stack) and
    HeteroPipe over (pipe 4), forward and gradients, with the controls
    (one rotation dropped), and the checks at :98-105."""
    from deeplearning4j_tpu_torch.parallel import GPipe, HeteroPipe

    mesh = DeviceMesh(data=1, pipe=WORLD_SEQ, device="cpu")
    out = _pipelines(p, mesh)
    g = p["gpipe"]
    x = torch.as_tensor(g["x"])
    pipe = GPipe(stage_dense, mesh, n_microbatches=4)
    for at in (1, 3):
        with _DropRotation(at):
            out[("dropped", at)] = pipe(_t(g["stacked"]), x).numpy()
    out["bad_stages"] = _raises(pipe, _t({k: v[:2] for k, v in
                                          g["stacked"].items()}), x)
    out["bad_batch"] = _raises(pipe, _t(g["stacked"]), x[:6])
    out["hetero_bad_stages"] = _raises(
        HeteroPipe, _hetero_fns(4), [None] * 4, [(4,)] * 4, mesh)
    return out


def pipeline_world1(rank, p):
    """GPipe(pipe=1) train steps through a group of one rank against the
    same steps run sequentially on the same microbatches."""
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import GPipe, pipeline_train_step

    mesh = DeviceMesh(data=1, pipe=1, device="cpu")
    tr = p["train1"]

    def sequential(stacked, x):
        ref = GPipe(stage_dense, None, n_microbatches=4)
        return torch.cat([ref.sequential_reference(stacked, m)
                          for m in x.chunk(4)])

    runs = {}
    for name, pipe in (("pipe1", GPipe(stage_dense, mesh, n_microbatches=4)),
                       ("sequential", sequential)):
        step = pipeline_train_step(
            pipe, lambda pred, y: ((pred - y) ** 2).mean(), Sgd(lr=0.2),
            lambda hp, h: h @ hp["W"])
        params = _t(tr["params"])
        opt = Sgd(lr=0.2).init_state(params)
        losses = []
        for i in range(tr["steps"]):
            params, opt, loss = step(params, opt, i,
                                     torch.as_tensor(tr["x"]),
                                     torch.as_tensor(tr["y"]))
            losses.append(float(loss))
        runs[name] = (losses, np_tree(params))
    return runs


# -------------------------------------------------------------- inference

def inference_world(rank, p):
    """ParallelInference(mesh=...).output over "data": every rank's result,
    and the control (every rank running the first slice)."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.util.serialization import restore_model

    net = restore_model(p["zip"], device="cpu")
    mesh = DeviceMesh(device="cpu")
    pi = ParallelInference(net, mesh=mesh, device="cpu")
    out = {n: pi.output(x).numpy() for n, x in p["xs"].items()}
    mesh.index = lambda axis: 0
    out["control"] = pi.output(p["xs"]["even"]).numpy()
    return out


# ------------------------------------------------------------------ spark

class MultiStream:
    """A resettable MultiDataSet stream: the same batches every epoch."""

    def __init__(self, mds_cls, feats, labels, batch, fmask=None,
                 lmask=None):
        self.mds = mds_cls(feats, labels, features_mask=fmask,
                           labels_mask=lmask)
        self.batch = batch

    def __iter__(self):
        return iter(self.mds.batches(self.batch))

    def reset(self):
        pass


def spark_stream(pkg, spec):
    """The stream ``spec`` describes, built from ``pkg``'s datasets (the
    JAX package's or the port's)."""
    import importlib

    ds_mod = importlib.import_module(f"{pkg}.datasets.dataset")
    it_mod = importlib.import_module(f"{pkg}.datasets.iterators")
    kind = spec["kind"]
    if kind == "array":
        return it_mod.ArrayDataSetIterator(spec["x"], spec["y"],
                                           batch_size=spec["batch"])
    if kind == "multi":
        return MultiStream(ds_mod.MultiDataSet, spec["x"], spec["y"],
                           spec["batch"], spec.get("fmask"),
                           spec.get("lmask"))
    if kind == "list":
        return [ds_mod.DataSet(x, y, features_mask=m)
                for x, y, m in spec["batches"]]
    if kind == "oneshot":
        return iter([ds_mod.DataSet(spec["x"], spec["y"])])
    raise ValueError(kind)


def spark_score(pkg, net, spec):
    import importlib

    ds_mod = importlib.import_module(f"{pkg}.datasets.dataset")
    if spec["kind"] == "multi":
        return float(net.score(ds_mod.MultiDataSet(
            spec["x"], spec["y"], features_mask=spec.get("fmask"))))
    if spec["kind"] == "list":
        xs, ys, ms = (np.concatenate(a) for a in zip(*spec["batches"]))
        return float(net.score(ds_mod.DataSet(xs, ys, features_mask=ms)))
    return float(net.score((spec["x"], spec["y"])))


def _forgetting(fit, spark, lost):
    def run(*a, **kw):
        orig = spark.RoundSupervisor.lost_for_round
        spark.RoundSupervisor.lost_for_round = lambda self: list(lost)
        try:
            return fit(*a, **kw)
        finally:
            spark.RoundSupervisor.lost_for_round = orig

    return run


def run_spark(pkg, sc, mesh, net, lost=None):
    """One Spark scenario through ``pkg``'s shims: (score before, score
    after, params, state, accuracy or None, warnings, supervisor counts,
    the error raised or None)."""
    import importlib
    import warnings

    spark = importlib.import_module(f"{pkg}.parallel.spark")
    tm = (spark.ParameterAveragingTrainingMaster.Builder()
          .batch_size_per_worker(sc["bpw"]).averaging_frequency(sc["k"])
          .straggler_timeout_s(sc.get("straggler", 0.0)).build())
    cls = (spark.SparkComputationGraph if sc.get("graph_facade")
           else spark.SparkDl4jMultiLayer)
    facade = cls(mesh, net, tm)
    if lost is not None:
        # the control: an average that forgets replicas ``lost`` every
        # round (the facade's supervisor answers with them)
        facade._fit_local_sgd = _forgetting(facade._fit_local_sgd, spark,
                                            lost)
    l0 = spark_score(pkg, net, sc["score"])
    err, injected, metrics, wall = None, None, None, None
    faults = importlib.import_module(f"{pkg}.faults")
    monitoring = importlib.import_module(f"{pkg}.monitoring")
    spec, delay = sc.get("faults", (None, 0.0))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            if spec is None:
                facade.fit(spark_stream(pkg, sc["data"]),
                           epochs=sc["epochs"])
            else:
                monitoring.enable()
                with faults.injected(spec, delay_s=delay) as plan:
                    t0 = time.monotonic()
                    facade.fit(spark_stream(pkg, sc["data"]),
                               epochs=sc["epochs"])
                    wall = time.monotonic() - t0
                injected = dict(plan.injected)
                metrics = [line for line in
                           monitoring.metrics_text().splitlines()
                           if 'component="localsgd"' in line
                           and line.startswith("dl4j_recovery_total")]
        except (ValueError, NotImplementedError) as e:
            err = (type(e).__name__, str(e))
    l1 = spark_score(pkg, net, sc["score"]) if err is None else None
    acc = None
    if sc.get("accuracy") and err is None:
        d = sc["score"]
        x = d["x"] if d["kind"] != "multi" else dict(zip(d["names"], d["x"]))
        out = net.output(x)
        out = out[0] if isinstance(out, (list, tuple)) else out
        out = np.asarray(out.detach().cpu() if hasattr(out, "detach")
                         else out)
        want = d["y"][0] if d["kind"] == "multi" else d["y"]
        acc = float((out.argmax(-1) == np.asarray(want).argmax(-1)).mean())
    sup = getattr(facade, "_round_supervisor", None)
    return {"l0": l0, "l1": l1, "params": np_tree(net.params),
            "state": np_tree(net.state), "acc": acc,
            "warned": [str(r.message) for r in rec
                       if "dropped" in str(r.message)],
            "supervisor": None if sup is None else (sup.dropped,
                                                    sup.readmitted),
            "error": err, "injected": injected, "metrics": metrics,
            "wall": wall}


def spark_world(rank, scenarios):
    """Every Spark scenario through the port's shims over every rank on
    "data" (gloo)."""
    out = {}
    for name, sc in scenarios.items():
        net = _port_net(sc["net"])
        out[name] = run_spark("deeplearning4j_tpu_torch", sc,
                              DeviceMesh(device="cpu"), net,
                              lost=sc.get("force_lost"))
    return out


def spark_world1(rank, sc):
    """Config-sized check at one replica: the Spark routes (K = 1 and
    K > 1) against the plain fit_batch on the same batches, and the
    PerEntryUpdater against the network's own _apply_updaters."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ArrayDataSetIterator,
    )
    from deeplearning4j_tpu_torch.optimize.updaters import PerEntryUpdater
    from deeplearning4j_tpu_torch.parallel import (
        ParameterAveragingTrainingMaster, SparkDl4jMultiLayer,
    )

    x, y = sc["x"], sc["y"]
    out = {}
    plain = _port_net(sc["net"])
    for i in range(0, len(x), sc["batch"]):
        plain.fit_batch((x[i:i + sc["batch"]], y[i:i + sc["batch"]]))
    out["plain"] = (np_tree(plain.params), np_tree(plain.opt_state))
    mesh = DeviceMesh(data=1, device="cpu")
    for k in (1, 5):
        net = _port_net(sc["net"])
        tm = (ParameterAveragingTrainingMaster.Builder()
              .batch_size_per_worker(sc["batch"]).averaging_frequency(k)
              .build())
        SparkDl4jMultiLayer(mesh, net, tm).fit(
            ArrayDataSetIterator(x, y, batch_size=sc["batch"]), epochs=1)
        out[k] = (np_tree(net.params), np_tree(net.opt_state))
    net = _port_net(sc["per_entry_net"])
    grads = tree_map(lambda a: torch.full_like(a, 0.01), net.params)
    mine = net._apply_updaters(grads, net.params, net.opt_state, 3)
    per = PerEntryUpdater(net._updaters).update(grads, net.opt_state,
                                                net.params, 3)
    per = (tree_map(lambda p, d: p - d, net.params, per[0]), per[1])
    out["per_entry"] = (np_tree(mine), np_tree(per))
    return out


# ------------------------------------------------------ fault tolerance

def _ft_run(make, directory, steps, batch, crash_at=None):
    """A FaultTolerantTrainer over ``make()`` from ``directory`` to
    ``steps`` steps (save_every 5), abandoned after step ``crash_at``
    (its pending writes flushed, as a killed process's committed steps
    are). Returns (the wrapper, the trainer, the saves this rank made)."""
    from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer

    wrapper = make()
    tr = FaultTolerantTrainer(wrapper, directory, save_every=5)
    saves = []
    orig = tr.checkpointer.save
    tr.checkpointer.save = lambda step, m: (saves.append(step),
                                            orig(step, m))
    target = tr._target
    while target.step_count < steps:
        tr.fit_batch(batch)
        if crash_at is not None and target.step_count == crash_at:
            break
    tr.checkpointer.wait()
    return wrapper, tr, saves


def ft_world(rank, p):
    """Kill-and-resume under ranks: a ParallelWrapper (replicated: rank 0
    writes) and a TensorParallel (sharded: a shard a rank), each run 10
    steps uninterrupted, and crashed at step 7 then resumed by a new
    trainer, against each other."""
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, TensorParallel,
    )

    out = {}
    batch = p["batch"]
    for kind in ("wrapper", "tensor"):
        def make():
            net = _port_net(p["net"])
            if kind == "wrapper":
                return ParallelWrapper(net, DeviceMesh(device="cpu"),
                                       prefetch_buffer=0)
            return TensorParallel(net, DeviceMesh(data=1, model=WORLD_SEQ // 2,
                                                  device="cpu"))

        def whole(w):
            return (_whole(w) if kind == "tensor"
                    else np_tree(w.model.params))

        d_plain = f"{p['dir']}/{kind}_plain"
        d_crash = f"{p['dir']}/{kind}_crash"
        plain, _, plain_saves = _ft_run(make, d_plain, 10, batch)
        _, _, crash_saves = _ft_run(make, d_crash, 10, batch, crash_at=7)
        dist.barrier()
        resumed, tr, resume_saves = _ft_run(make, d_crash, 10, batch)
        tr.fit([batch], epochs=0)      # fit's closing save and barrier
        out[kind] = {"restored": tr.restored_step,
                     "saves": (plain_saves, crash_saves, resume_saves),
                     "plain": whole(plain), "resumed": whole(resumed),
                     "plain_opt": np_tree(plain.model.opt_state),
                     "resumed_opt": np_tree(resumed.model.opt_state)}
    return out
