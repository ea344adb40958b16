"""The port's reinforcement learning (``deeplearning4j_tpu_torch/rl/``)
against the JAX package's, on the CPU.

The environments, history stacks and replay samples are the JAX package's
numpy, copied: held equal. The Q-nets and the updates are held within
``TOL`` (f32, relative to the largest entry) from the same weights,
carried across by ``rl.load_jax_state``: Q-values of the dense, conv
(odd frames, so XLA's SAME puts a pad at the end) and dueling nets; the
params and Adam's moments after 1 and 5 DQN updates for double and plain
DQN, Huber and squared loss, n_step 1 and 3; the actor-critic loss and
update beside a control that swaps in torch's unbiased std (ddof 1), which
misses. A DQN ``train_episode`` and an A2C ``train_iteration`` from the
same weights and seed take the same actions and end within ``TOL``.
``tests/test_rl.py``'s cases run on the port in
``test_torch_rl_cases.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.rl as jrl
import deeplearning4j_tpu.rl.actor_critic as jax_ac
import deeplearning4j_tpu_torch.rl as rl
import deeplearning4j_tpu_torch.rl.actor_critic as port_ac
from deeplearning4j_tpu_torch.rl import load_jax_state

TOL = 1e-5

QDense = functools.partial(rl.QLearningDiscreteDense, device="cpu")
QConv = functools.partial(rl.QLearningDiscreteConv, device="cpu")
A2C = functools.partial(rl.A2CDiscreteDense, device="cpu")
A3CDense = functools.partial(rl.A3CDiscreteDense, device="cpu")
A3CConv = functools.partial(rl.A3CDiscreteConv, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One PyTorch intra-op thread for this file's tests: tier-1 runs six
    workers over the machine's cores, and at the default pool size their
    OpenMP threads oversubscribe them (the RL conv cases ran ~20x slower
    in six parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def rel(got, want):
    """Largest |got - want| over the largest |want|, over every leaf of two
    trees of the same structure."""
    g = [np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                    np.float64).ravel()
         for a in jax.tree_util.tree_leaves(got)]
    w = [np.asarray(a, np.float64).ravel()
         for a in jax.tree_util.tree_leaves(want)]
    assert [a.shape for a in g] == [a.shape for a in w]
    g, w = np.concatenate(g), np.concatenate(w)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def torch_tree(t):
    return jax.tree_util.tree_map(lambda a: a.numpy(), t)


def test_exports_equal_the_jax_all():
    assert set(jrl.__all__) <= set(rl.__all__)
    assert set(rl.__all__) - set(jrl.__all__) == {"load_jax_state"}


def test_entry_points_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rl.QLearningDiscreteDense(rl.CartPole(seed=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rl.A2CDiscreteDense(rl.CartPole(seed=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rl.A3CDiscreteDense(lambda i: rl.CartPole(seed=i), n_envs=2)


# ------------------------------------------------------ host numpy, copied

def _rollout(env, actions):
    out = [env.reset()]
    for a in actions:
        o, r, d = env.step(a)
        out += [o, np.float32(r), np.float32(d)]
        if d:
            out.append(env.reset())
    return out


@pytest.mark.parametrize("make", [
    lambda m: m.CartPole(seed=3, max_steps=30),
    lambda m: m.PixelGridWorld(size=9, max_steps=12, seed=5),
    lambda m: m.FrameSkipWrapper(m.PixelGridWorld(size=8, max_steps=20,
                                                  seed=1), skip=3),
], ids=["cartpole", "pixelgrid", "frameskip"])
def test_environments_equal_jax(make):
    acts = np.random.default_rng(0).integers(0, 2, 80).tolist()
    got, want = _rollout(make(rl), acts), _rollout(make(jrl), acts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_history_stacks_equal_jax():
    rng = np.random.default_rng(1)
    kw = dict(history_length=3, rescaled_height=7, rescaled_width=5,
              crop_top=1, crop_bottom=2, crop_left=2, crop_right=1)
    got, want = rl.HistoryProcessor(**kw), jrl.HistoryProcessor(**kw)
    for t in range(9):
        f = rng.random((16, 12, 3)).astype(np.float32)
        if t == 5:
            got.reset(), want.reset()
        np.testing.assert_array_equal(got.observe(f), want.observe(f))
    assert got.output_shape == want.output_shape


def _fill(buf, rng, n, shape, k=None):
    for t in range(n):
        if k is None:
            o, no = rng.random(shape), rng.random(shape)
        else:
            o = rng.random((*shape, k)).astype(np.float32)
            no = np.concatenate([o[..., 1:], rng.random((*shape, 1))], -1)
        buf.store(o, int(rng.integers(3)), float(rng.normal()), no,
                  bool(t % 7 == 6))


@pytest.mark.parametrize("kind", ["exp", "nstep", "framestack"])
def test_replay_samples_equal_jax(kind):
    bufs = []
    for m in (rl, jrl):
        rng = np.random.default_rng(2)
        if kind == "exp":
            b = m.ExpReplay(16, 3, seed=4)
            _fill(b, rng, 40, (3,))
        elif kind == "nstep":
            b = m.NStepAccumulator(m.ExpReplay(32, (2, 2), seed=4), 3, 0.9)
            _fill(b, rng, 40, (2, 2))
        else:
            b = m.FrameStackReplay(24, (3, 3), 4, seed=4, n_step=3,
                                   gamma=0.9)
            _fill(b, rng, 40, (3, 3), k=4)
        bufs.append(b)
    assert len(bufs[0]) == len(bufs[1])
    for _ in range(3):
        for g, w in zip(bufs[0].sample(11), bufs[1].sample(11)):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- the Q-nets

def _pair(kind, dueling, **kw):
    """(port agent, JAX agent), the port given the JAX agent's state."""
    if kind == "dense":
        env = lambda m: m.CartPole(seed=0)
        port = QDense(env(rl), hidden=[16, 8], dueling=dueling, seed=3, **kw)
        jx = jrl.QLearningDiscreteDense(env(jrl), hidden=[16, 8],
                                        dueling=dueling, seed=3, **kw)
    else:
        mk = lambda m: (m.PixelGridWorld(size=11, max_steps=8, seed=0),
                        m.HistoryProcessor(history_length=2)
                        .set_input_shape(11, 11))
        port = QConv(*mk(rl), channels=(4, 6), dense=12, dueling=dueling,
                     seed=3, **kw)
        jx = jrl.QLearningDiscreteConv(*mk(jrl), channels=(4, 6), dense=12,
                                       dueling=dueling, seed=3, **kw)
    load_jax_state(port, np_tree(jx.params), np_tree(jx.target_params),
                   np_tree(jx.opt["state"]), int(jx.opt["step"]))
    return port, jx


def _obs(kind, rng, b):
    shape = (b, 4) if kind == "dense" else (b, 11, 11, 2)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kind,dueling", [("dense", False), ("dense", True),
                                          ("conv", False), ("conv", True)])
def test_q_values_against_jax(kind, dueling):
    port, jx = _pair(kind, dueling)
    x = _obs(kind, np.random.default_rng(5), 9)
    want = np.asarray(jx._q_fn(jx.params, jnp.asarray(x)))
    assert rel(port.q_values(x), want) <= TOL


def _batch(kind, rng, b, n_actions=2):
    return (_obs(kind, rng, b), rng.integers(0, n_actions, b).astype(np.int32),
            rng.normal(size=b).astype(np.float32), _obs(kind, rng, b),
            (rng.random(b) < 0.3).astype(np.float32))


def _updates(port, jx, kind, n):
    rng = np.random.default_rng(7)
    for _ in range(n):
        batch = _batch(kind, rng, 8)
        port.update(*batch)
        jx.params, jx.opt, _ = jx._step_fn(
            jx.params, jx.opt, jx.target_params,
            *(jnp.asarray(a) for a in batch))


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("double_dqn,error_clamp,n_step", [
    (True, 1.0, 1), (False, 1.0, 3), (True, 0.0, 3), (False, 0.0, 1)])
def test_dqn_updates_against_jax(n, double_dqn, error_clamp, n_step):
    port, jx = _pair("dense", True, double_dqn=double_dqn,
                     error_clamp=error_clamp, n_step=n_step, gamma=0.9)
    _updates(port, jx, "dense", n)
    assert port.opt["step"] == int(jx.opt["step"]) == n
    assert rel(port.params, np_tree(jx.params)) <= TOL
    assert rel(port.opt["state"], np_tree(jx.opt["state"])) <= TOL
    # the target is a copy: the updates moved the params, not it
    assert rel(port.target_params, np_tree(jx.target_params)) == 0.0
    assert rel(port.params, np_tree(jx.target_params)) > 1e-4


def test_conv_dqn_updates_against_jax():
    port, jx = _pair("conv", False, n_step=3)
    _updates(port, jx, "conv", 3)
    assert rel(port.params, np_tree(jx.params)) <= TOL
    assert rel(port.opt["state"], np_tree(jx.opt["state"])) <= TOL


def test_dqn_train_episode_takes_jax_actions():
    kw = dict(hidden=[16], min_replay=12, batch_size=8,
              target_update_freq=10, eps_decay_steps=40, n_step=3, seed=2)
    port = QDense(rl.CartPole(seed=4, max_steps=60), **kw)
    jx = jrl.QLearningDiscreteDense(jrl.CartPole(seed=4, max_steps=60), **kw)
    load_jax_state(port, np_tree(jx.params),
                   opt_state=np_tree(jx.opt["state"]),
                   step=int(jx.opt["step"]))
    acts = {}
    for name, agent in (("port", port), ("jax", jx)):
        seen, step = [], agent.mdp.step
        agent.mdp.step = lambda a, s=step, l=seen: (l.append(a), s(a))[1]
        acts[name] = seen
        rewards = [agent.train_episode() for _ in range(3)]
        acts[name + "_rewards"] = rewards
    assert acts["port"] == acts["jax"] and len(acts["port"]) > 20
    assert acts["port_rewards"] == acts["jax_rewards"]
    assert rel(port.params, np_tree(jx.params)) <= TOL
    assert rel(port.target_params, np_tree(jx.target_params)) <= TOL


# --------------------------------------------------------- actor-critic

def _ac_inputs(rng, b=24, a=3):
    return (rng.normal(size=(b, a)).astype(np.float32),
            rng.normal(size=b).astype(np.float32),
            rng.integers(0, a, b).astype(np.int32),
            rng.normal(size=b).astype(np.float32))


@pytest.mark.parametrize("normalize", [False, True])
def test_ac_loss_against_jax(normalize):
    logits, values, acts, rets = _ac_inputs(np.random.default_rng(0))
    want = float(jax_ac._ac_loss(jnp.asarray(logits), jnp.asarray(values),
                                 jnp.asarray(acts), jnp.asarray(rets), 0.5,
                                 0.01, normalize_adv=normalize))
    got = float(port_ac._ac_loss(torch.tensor(logits), torch.tensor(values),
                                 torch.tensor(acts, dtype=torch.int64),
                                 torch.tensor(rets), 0.5, 0.01,
                                 normalize_adv=normalize))
    assert abs(got - want) <= TOL * abs(want)


def _a3c_pair(conv):
    if conv:
        env = lambda m: (lambda i: m.PixelGridWorld(size=7, max_steps=9,
                                                    seed=20 + i))
        hist = lambda m: (lambda i: m.HistoryProcessor(history_length=2)
                          .set_input_shape(7, 7))
        kw = dict(n_envs=3, channels=(4,), dense=8, t_max=6, seed=1)
        return (A3CConv(env(rl), hist(rl), **kw),
                jrl.A3CDiscreteConv(env(jrl), hist(jrl), **kw))
    env = lambda m: (lambda i: m.CartPole(seed=30 + i, max_steps=15))
    kw = dict(n_envs=4, hidden=(12,), t_max=7, seed=1)
    return A3CDense(env(rl), **kw), jrl.A3CDiscreteDense(env(jrl), **kw)


@pytest.mark.parametrize("conv", [False, True], ids=["dense", "conv"])
def test_a3c_segments_against_jax(conv):
    """Two segments from the same weights: the same actions (their
    observations equal), losses and params within TOL."""
    port, jx = _a3c_pair(conv)
    load_jax_state(port, np_tree(jx.params))
    for _ in range(2):
        lp, lj = port.train_segment(), jx.train_segment()
        # a loss near 0 is a difference of O(1) terms: absolute below 1
        assert abs(lp - lj) <= TOL * max(abs(lj), 1.0)
        for a, b in zip(port._obs, jx._obs):
            np.testing.assert_array_equal(a, b)
    assert port.episode_rewards == jx.episode_rewards
    assert rel(port.params, np_tree(jx.params)) <= TOL


def test_a3c_update_uses_the_population_std(monkeypatch):
    """The A3C update within TOL of JAX's; with torch's default unbiased
    std swapped in (the planted control) it misses by far more."""
    port, jx = _a3c_pair(False)
    start = np_tree(jx.params)
    # a peaked policy, so the advantage's scale reaches the loss (at the
    # 0.01-scale init the log-probabilities are all about log(1/2) and the
    # policy term is near 0 whatever the std)
    start["pi"]["W"] = start["pi"]["W"] * 300
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(12, 4)).astype(np.float32)
    acts = rng.integers(0, 2, 12).astype(np.int32)
    rets = rng.normal(size=12).astype(np.float32) * 3
    new, loss = jx._update(jax.tree_util.tree_map(jnp.asarray, start),
                           jnp.asarray(obs), jnp.asarray(acts),
                           jnp.asarray(rets))

    def port_update():
        load_jax_state(port, start)
        got = float(port.update(obs, acts, rets))
        return abs(got - float(loss)) / abs(float(loss)), rel(
            port.params, np_tree(new))

    loss_err, param_err = port_update()
    assert loss_err <= TOL and param_err <= TOL
    orig = torch.Tensor.std
    monkeypatch.setattr(torch.Tensor, "std",
                        lambda self, *a, **k: orig(self))
    c_loss, c_param = port_update()
    assert c_loss > 100 * TOL and c_param > 10 * TOL, (c_loss, c_param)


def test_a2c_step_and_iteration_against_jax():
    kw = dict(hidden=[12], lr=0.05, rollout_episodes=2, seed=6)
    port = A2C(rl.CartPole(seed=8, max_steps=25), **kw)
    jx = jrl.A2CDiscreteDense(jrl.CartPole(seed=8, max_steps=25), **kw)
    load_jax_state(port, np_tree(jx.params))
    acts = {}
    for name, agent in (("port", port), ("jax", jx)):
        seen, step = [], agent.mdp.step
        agent.mdp.step = lambda a, s=step, l=seen: (l.append(a), s(a))[1]
        acts[name] = seen
        acts[name + "_loss"] = [agent.train_iteration() for _ in range(3)]
    assert acts["port"] == acts["jax"]
    np.testing.assert_allclose(acts["port_loss"], acts["jax_loss"],
                               rtol=TOL, atol=TOL)
    assert port.episode_rewards == jx.episode_rewards
    assert rel(port.params, np_tree(jx.params)) <= TOL


def test_load_jax_state_checks_the_tree():
    port, jx = _pair("dense", False)
    bad = np_tree(jx.params)
    bad["trunk"][0]["W"] = bad["trunk"][0]["W"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        load_jax_state(port, bad)
    a2c = A2C(rl.CartPole(seed=0), hidden=[8])
    with pytest.raises(ValueError, match="no target"):
        load_jax_state(a2c, torch_tree(a2c.params), opt_state={})


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_dqn_updates_on_the_card_against_the_cpu(kind):
    """The same seed draws the same weights on both devices (the CPU
    draws, then moves); three updates from the same batches agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    agents = []
    for dev in ("cuda", "cpu"):
        if kind == "dense":
            agents.append(rl.QLearningDiscreteDense(
                rl.CartPole(seed=0), hidden=[32, 16], dueling=True,
                n_step=3, seed=3, device=dev))
        else:
            agents.append(rl.QLearningDiscreteConv(
                rl.PixelGridWorld(size=11, seed=0),
                rl.HistoryProcessor(history_length=2).set_input_shape(11, 11),
                channels=(8, 8), dense=16, dueling=True, seed=3, device=dev))
    rng = np.random.default_rng(7)
    for _ in range(3):
        batch = _batch(kind, rng, 16)
        for a in agents:
            a.update(*batch)
    card, cpu = (torch_tree(jax.tree_util.tree_map(
        lambda t: t.detach().cpu(), a.params)) for a in agents)
    assert rel(card, cpu) <= TOL


@pytest.mark.cuda
def test_a3c_update_on_the_card_against_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    make = lambda dev: rl.A3CDiscreteConv(
        lambda i: rl.PixelGridWorld(size=9, seed=i),
        lambda i: rl.HistoryProcessor(history_length=2).set_input_shape(9, 9),
        n_envs=4, channels=(8,), dense=16, t_max=5, seed=2, device=dev)
    card, cpu = make("cuda"), make("cpu")
    rng = np.random.default_rng(1)
    obs = rng.random((20, 9, 9, 2)).astype(np.float32)
    acts = rng.integers(0, 2, 20)
    rets = rng.normal(size=20).astype(np.float32)
    lc, lp = float(card.update(obs, acts, rets)), float(cpu.update(
        obs, acts, rets))
    assert abs(lc - lp) <= TOL * max(abs(lp), 1.0)
    assert rel(torch_tree(jax.tree_util.tree_map(
        lambda t: t.detach().cpu(), card.params)),
        torch_tree(cpu.params)) <= TOL
