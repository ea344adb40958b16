"""``tests/test_rl.py``'s cases on the port's reinforcement learning
(``deeplearning4j_tpu_torch/rl/``) with ``device="cpu"``: CartPole, the
replay buffers, the history processor, DQN (dense, dueling, conv over the
frame ring), A2C and the batched A3C, as the JAX package runs them. The
learning cases start from the JAX agent's initial weights (through
``rl.load_jax_state``): the port draws its own from torch generators, not
threefry, and a learning curve over a few hundred episodes depends on
where it starts. The parity tests against the JAX package are in
``test_torch_rl.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.rl as jrl
import deeplearning4j_tpu_torch.rl as rl
from deeplearning4j_tpu_torch.rl import load_jax_state

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


def jax_start(port, jax_agent):
    return load_jax_state(port, jax.tree_util.tree_map(np.asarray,
                                                       jax_agent.params))


class TestCartPole:
    def test_episode_terminates(self):
        env = rl.CartPole(seed=0)
        obs = env.reset()
        assert obs.shape == (4,)
        steps = 0
        done = False
        while not done:
            obs, r, done = env.step(steps % 2)
            assert r == 1.0
            steps += 1
        assert 1 <= steps <= 200

    def test_balanced_policy_lasts_longer_than_bad(self):
        def run(policy):
            env = rl.CartPole(seed=3)
            obs = env.reset()
            n, done = 0, False
            while not done:
                obs, _, done = env.step(policy(obs))
                n += 1
            return n

        assert run(lambda o: 1 if o[2] > 0 else 0) > run(lambda o: 0)


class TestExpReplay:
    def test_circular_and_sample(self):
        buf = rl.ExpReplay(capacity=8, obs_size=2, seed=0)
        for i in range(12):
            buf.store([i, i], i % 2, float(i), [i + 1, i + 1], i == 11)
        assert len(buf) == 8
        obs, acts, rews, nxt, dones = buf.sample(16)
        assert obs.shape == (16, 2)
        assert rews.min() >= 4.0


class TestDQN:
    def test_learns_cartpole(self):
        kw = dict(hidden=[64], lr=1e-3, min_replay=300,
                  target_update_freq=200, eps_decay_steps=4000, seed=3)
        ql = jax_start(QDense(rl.CartPole(seed=1, max_steps=200), **kw),
                       jrl.QLearningDiscreteDense(jrl.CartPole(seed=1), **kw))
        rews = ql.train(200)
        first, last = np.mean(rews[:20]), np.mean(rews[-20:])
        assert last > 2.5 * first, (first, last)
        assert ql.play_episode() > 40

    def test_epsilon_anneals(self):
        ql = QDense(rl.CartPole(seed=0), eps_decay_steps=10, seed=0)
        assert ql.epsilon() == 1.0
        ql.step_count = 10
        assert ql.epsilon() == pytest.approx(0.05)


class TestA2C:
    def test_improves_cartpole(self):
        a2c = jax_start(A2C(rl.CartPole(seed=2, max_steps=200), lr=0.02,
                            seed=4),
                        jrl.A2CDiscreteDense(jrl.CartPole(seed=2), seed=4))
        a2c.train(40)
        assert a2c.play_episode() > 40


class TestHistoryProcessor:
    def test_stack_and_rescale(self):
        hp = rl.HistoryProcessor(history_length=3, rescaled_height=4,
                                 rescaled_width=4)
        f0 = np.zeros((8, 8), np.float32)
        f0[0, 0] = 1.0
        out = hp.observe(f0)
        assert out.shape == (4, 4, 3)
        assert np.array_equal(out[..., 0], out[..., 2])
        out = hp.observe(np.ones((8, 8), np.float32))
        assert out[..., -1].mean() == 1.0
        assert out[..., 0].mean() < 1.0
        assert hp.output_shape == (4, 4, 3)

    def test_crop_and_grayscale(self):
        hp = rl.HistoryProcessor(history_length=1, crop_top=2, crop_bottom=2,
                                 crop_left=1, crop_right=1)
        rgb = np.zeros((8, 6, 3), np.float32)
        rgb[..., 0] = 3.0
        out = hp.observe(rgb)
        assert out.shape == (4, 4, 1)
        assert np.allclose(out, 1.0)

    def test_reset_clears_stack(self):
        hp = rl.HistoryProcessor(history_length=2)
        hp.observe(np.zeros((4, 4), np.float32))
        hp.observe(np.ones((4, 4), np.float32))
        hp.reset()
        out = hp.observe(np.full((4, 4), 0.5, np.float32))
        assert np.allclose(out, 0.5)


class TestNStepReplay:
    def test_accumulates_discounted_rewards(self):
        buf = rl.ExpReplay(capacity=16, obs_size=1, seed=0)
        acc = rl.NStepAccumulator(buf, n_step=3, gamma=0.5)
        for t, (r, done) in enumerate([(1, False), (2, False), (4, False),
                                       (8, True)]):
            acc.store([t], 0, r, [t + 1], done)
        assert len(buf) == 4
        assert buf.rewards[0] == pytest.approx(3.0)
        assert buf.next_obs[0, 0] == 3.0
        assert buf.dones[0] == 0.0
        assert buf.rewards[1] == pytest.approx(6.0)
        assert buf.dones[1] == 1.0
        assert buf.rewards[3] == pytest.approx(8.0)

    def test_pending_cleared_between_episodes(self):
        buf = rl.ExpReplay(capacity=16, obs_size=1, seed=0)
        acc = rl.NStepAccumulator(buf, n_step=3, gamma=1.0)
        acc.store([0], 0, 1.0, [1], True)
        acc.store([10], 0, 5.0, [11], False)
        assert len(buf) == 1
        assert buf.rewards[0] == 1.0


class TestDuelingAndConv:
    def test_dueling_dense_learns_cartpole(self):
        kw = dict(hidden=[64], lr=2e-3, min_replay=300,
                  target_update_freq=200, eps_decay_steps=2000, dueling=True,
                  n_step=3, seed=3)
        ql = jax_start(QDense(rl.CartPole(seed=1, max_steps=120), **kw),
                       jrl.QLearningDiscreteDense(jrl.CartPole(seed=1), **kw))
        rews = ql.train(150)
        first, last = np.mean(rews[:20]), np.mean(rews[-20:])
        assert last > 1.8 * first, (first, last)

    def test_conv_pixel_learning(self):
        mk = lambda m: (m.PixelGridWorld(size=8, max_steps=30, seed=0),
                        m.HistoryProcessor(history_length=2)
                        .set_input_shape(8, 8))
        kw = dict(channels=(8,), dense=32, lr=2e-3, batch_size=32,
                  min_replay=64, target_update_freq=100, eps_decay_steps=600,
                  dueling=True, seed=0)
        ql = jax_start(QConv(*mk(rl), **kw),
                       jrl.QLearningDiscreteConv(*mk(jrl), **kw))
        rews = ql.train(60)
        late = rews[-15:]
        assert np.mean([r > 0.5 for r in late]) > 0.6, late
        assert ql.play_episode() > 0.5

    def test_frame_skip_wrapper(self):
        env = rl.FrameSkipWrapper(rl.PixelGridWorld(size=8, max_steps=30,
                                                    seed=0), skip=2)
        env.reset()
        obs, r, done = env.step(1)
        assert obs.shape == (8, 8)


class TestFrameStackReplay:
    def _mk(self, capacity=32, k=3, shape=(4, 4)):
        return rl.FrameStackReplay(capacity, shape, k, seed=0)

    def _frame(self, v):
        return np.full((4, 4), float(v), np.float32)

    def _stack(self, *vs):
        return np.stack([self._frame(v) for v in vs], axis=-1)

    def test_stacks_match_what_was_stored(self):
        buf = self._mk()
        buf.store(self._stack(1, 1, 1), 0, 0.1, self._stack(1, 1, 2), False)
        buf.store(self._stack(1, 1, 2), 1, 0.2, self._stack(1, 2, 3), False)
        buf.store(self._stack(1, 2, 3), 0, 0.3, self._stack(2, 3, 4), True)
        assert len(buf) == 3
        obs, acts, rews, nxt, dones = buf.sample(64)
        for o, a, r, n, d in zip(obs, acts, rews, nxt, dones):
            if r == np.float32(0.1):
                assert np.array_equal(o, self._stack(1, 1, 1))
                assert np.array_equal(n, self._stack(1, 1, 2))
            elif r == np.float32(0.3):
                assert np.array_equal(o, self._stack(1, 2, 3))
                assert np.array_equal(n, self._stack(2, 3, 4))
                assert d == 1.0

    def test_no_cross_episode_stacks(self):
        buf = self._mk()
        buf.store(self._stack(7, 7, 7), 0, 1.0, self._stack(7, 7, 8), True)
        buf.store(self._stack(9, 9, 9), 1, 2.0, self._stack(9, 9, 10), True)
        obs, acts, rews, nxt, _ = buf.sample(32)
        for o in obs:
            vals = set(np.unique(o))
            assert vals <= {7.0} or vals <= {9.0}

    def test_memory_is_one_frame_per_step(self):
        buf = self._mk(capacity=100, k=4, shape=(8, 8))
        for t in range(10):
            buf.store(np.full((8, 8, 4), t, np.float32), 0, 0.0,
                      np.full((8, 8, 4), t + 1, np.float32), t == 9)
        assert buf.frames.shape == (100, 8, 8)
        assert len(buf) == 10

    def test_ring_overwrite_invalidates_cleanly(self):
        buf = self._mk(capacity=8, k=2)
        for ep in range(4):
            buf.store(self._stack(ep, ep), 0, float(ep),
                      self._stack(ep, ep + 10), False)
            buf.store(self._stack(ep, ep + 10), 1, float(ep) + 0.5,
                      self._stack(ep + 10, ep + 20), True)
        obs, acts, rews, nxt, dones = buf.sample(16)
        assert obs.shape == (16, 4, 4, 2)

    def test_conv_dqn_uses_frame_ring(self):
        env = rl.PixelGridWorld(size=8, max_steps=10, seed=0)
        hp = rl.HistoryProcessor(history_length=2).set_input_shape(8, 8)
        ql = QConv(env, hp, channels=(8,), dense=16, min_replay=8,
                   batch_size=8, seed=0)
        assert isinstance(ql.replay, rl.FrameStackReplay)
        ql.train(3)


class TestFrameStackReplayReviewRepros:
    def _frame(self, v, shape=(4, 4)):
        return np.full(shape, float(v), np.float32)

    def _stack(self, *vs):
        return np.stack([self._frame(v) for v in vs], axis=-1)

    def test_nstep_window_has_true_successor(self):
        buf = rl.FrameStackReplay(32, (4, 4), 3, seed=0, n_step=3, gamma=0.9)
        rewards = [1.0, 10.0, 100.0, 1000.0, 10000.0]
        for t, r in enumerate(rewards):
            obs = self._stack(max(0, t - 2), max(0, t - 1), t)
            nxt = self._stack(max(0, t - 1), t, t + 1)
            buf.store(obs, t % 2, r, nxt, t == 4)
        obs, acts, rews, nxt, dones = buf.sample(128)
        seen = set()
        for o, a, g, n, d in zip(obs, acts, rews, nxt, dones):
            t = int(o[0, 0, -1])
            seen.add(t)
            if t == 0:
                assert g == pytest.approx(1 + 0.9 * 10 + 0.81 * 100)
                assert n[0, 0, -1] == 3.0
                assert d == 0.0
            if t == 3:
                assert g == pytest.approx(1000 + 0.9 * 10000)
                assert n[0, 0, -1] == 5.0
                assert d == 1.0
        assert {0, 3} <= seen

    def test_wrapped_history_never_fabricated(self):
        buf = rl.FrameStackReplay(6, (4, 4), 3, seed=0)
        for t in range(8):
            obs = self._stack(max(0, t - 2), max(0, t - 1), t)
            nxt = self._stack(max(0, t - 1), t, t + 1)
            buf.store(obs, 0, float(t), nxt, t == 7)
        obs, _, rews, nxt, _ = buf.sample(64)
        for o, r in zip(obs, rews):
            t = int(r)
            expect = self._stack(max(0, t - 2), max(0, t - 1), t)
            assert np.array_equal(o, expect)

    def test_conv_nstep_trains(self):
        env = rl.PixelGridWorld(size=8, max_steps=12, seed=0)
        hp = rl.HistoryProcessor(history_length=2).set_input_shape(8, 8)
        ql = QConv(env, hp, channels=(8,), dense=16, min_replay=16,
                   batch_size=8, n_step=3, seed=0)
        assert isinstance(ql.replay, rl.FrameStackReplay)
        assert ql.replay.n_step == 3
        ql.train(4)


class TestA3CBatchedEnvs:
    def test_dense_learns_cartpole(self):
        env = lambda m: (lambda i: m.CartPole(seed=100 + i, max_steps=200))
        kw = dict(n_envs=8, hidden=(64,), lr=0.01, t_max=32, seed=5)
        a3c = jax_start(A3CDense(env(rl), **kw),
                        jrl.A3CDiscreteDense(env(jrl), **kw))
        a3c.train(120)
        assert a3c.play_episode() > 60

    def test_segments_bootstrap_unfinished(self):
        a3c = A3CDense(lambda i: rl.CartPole(seed=i), n_envs=4, t_max=5,
                       seed=0)
        loss = a3c.train_segment()
        assert np.isfinite(loss)
        assert len(a3c.episode_rewards) == 0

    def test_conv_pixel_smoke_and_learn(self):
        mk = lambda m: (
            lambda i: m.PixelGridWorld(size=8, max_steps=25, seed=50 + i),
            lambda i: m.HistoryProcessor(history_length=2)
            .set_input_shape(8, 8))
        kw = dict(n_envs=4, channels=(8,), dense=32, lr=5e-3, t_max=25,
                  seed=1)
        a3c = jax_start(A3CConv(*mk(rl), **kw),
                        jrl.A3CDiscreteConv(*mk(jrl), **kw))
        a3c.train(80)
        wins = sum(a3c.play_episode() > 0.5 for _ in range(5))
        assert wins >= 3, wins

    def test_play_episode_does_not_desync_training(self):
        a3c = A3CDense(lambda i: rl.CartPole(seed=i), n_envs=3, t_max=4,
                       seed=0)
        a3c.train_segment()
        obs_before = [o.copy() for o in a3c._obs]
        n_eps = len(a3c.episode_rewards)
        a3c.play_episode()
        for a, b in zip(obs_before, a3c._obs):
            assert np.array_equal(a, b)
        assert len(a3c.episode_rewards) == n_eps
        assert np.isfinite(a3c.train_segment())
