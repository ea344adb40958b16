"""Advantage actor-critic.

Counterpart of ``deeplearning4j_tpu/rl/actor_critic.py``: the same loss,
the same parameter tree (``trunk``, ``pi`` and ``v``, each ``{"W", "b"}``)
and the same host draws, in the same order, so the same weights and seed
take the same actions.

Reference analog: org.deeplearning4j.rl4j.learning.async.a3c.discrete.
A3CDiscreteDense — asynchronous advantage actor-critic with worker threads
sharing a global net. Here, as in the JAX package, it is synchronous
batched A2C: rollouts are collected on the host, and one update computes
the combined policy + value + entropy loss, ``autograd.grad`` and the SGD
step ``p - lr * g`` in place on the device.

The advantage is standardized with the population standard deviation
(``correction=0``): jnp's ``std`` divides by N, ``torch.std`` by N - 1
unless told otherwise. ``jax.lax.stop_gradient`` is ``.detach()``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.device import (
    DeviceLike, resolve_device, to_device,
)
from deeplearning4j_tpu_torch.common.trees import tree_leaves
from deeplearning4j_tpu_torch.rl.dqn import (
    _Key, _conv_trunk, _mlp_apply, _mlp_init, _subtract_, as_tensor,
    grads_of,
)
from deeplearning4j_tpu_torch.rl.env import MDP


def _ac_loss(logits, values, actions, returns, value_coef, entropy_coef,
             normalize_adv=False):
    """Combined policy + value + entropy loss (shared by the A2C and A3C
    paths). ``normalize_adv`` standardizes only the ADVANTAGE — the value
    head always regresses the raw returns, so its output stays on the
    absolute scale the A3C bootstrap feeds back in."""
    adv = returns - values.detach()
    if normalize_adv:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    logp = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(logp, 1, actions[:, None])[:, 0]
    policy_loss = -(chosen * adv).mean()
    value_loss = ((values - returns) ** 2).mean()
    entropy = -(torch.exp(logp) * logp).sum(-1).mean()
    return policy_loss + value_coef * value_loss - entropy_coef * entropy


def _heads_init(key: _Key, hidden_size: int, n_actions: int, device):
    k1, k2 = key.fold_in(99).split()
    return {"pi": {"W": k1.normal((hidden_size, n_actions), device) * 0.01,
                   "b": torch.zeros(n_actions, device=device)},
            "v": {"W": k2.normal((hidden_size, 1), device) * 0.01,
                  "b": torch.zeros(1, device=device)}}


def _heads_apply(p, h):
    logits = h @ p["pi"]["W"] + p["pi"]["b"]
    values = (h @ p["v"]["W"] + p["v"]["b"])[:, 0]
    return logits, values


def sgd_update(loss_fn, params, lr):
    """``params -= lr * grad(loss_fn)`` in place; returns the loss as a
    device scalar, unread."""
    loss, grads = grads_of(loss_fn, params)
    with torch.no_grad():
        _subtract_(params, [lr * g for g in tree_leaves(grads)])
    return loss


def _a2c_step(params, obs, actions, returns, lr, value_coef, entropy_coef):
    """One A2C update of the dense policy in place; returns the loss."""
    def loss_fn(p):
        h = torch.relu(_mlp_apply(p["trunk"], obs))
        logits, values = _heads_apply(p, h)
        return _ac_loss(logits, values, actions, returns, value_coef,
                        entropy_coef)

    return sgd_update(loss_fn, params, lr)


def _probs(logits: np.ndarray) -> np.ndarray:
    z = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return z / z.sum(axis=-1, keepdims=True)


class A3CDiscrete:
    """The A3C analog: N environment copies advanced in lockstep with ONE
    batched policy evaluation per step, t_max-segment rollouts with V(s_T)
    bootstrap for unfinished episodes, and a single combined
    policy+value+entropy update per segment.

    Reference analog: org.deeplearning4j.rl4j.learning.async.a3c.discrete.
    A3CDiscrete{Dense,Conv} — there, N async worker THREADS each own an env
    and race updates into a shared net; here the workers collapse into a
    batch dimension (synchronous batched A2C is the same estimator with
    strictly lower gradient staleness).

    ``env_factory(i) -> MDP`` builds the i-th environment copy (seeded
    differently per i). ``trunk``: (init(key, device), apply->hidden) pair;
    use ``a3c_dense_trunk`` / dqn's ``_conv_trunk``. ``device``: the card
    when None (raising without one), the CPU only when asked.
    """

    def __init__(self, env_factory, n_envs: int, trunk, hidden_size: int,
                 n_actions: int, observe=None, gamma: float = 0.99,
                 lr: float = 7e-3, value_coef: float = 0.5,
                 entropy_coef: float = 0.01, t_max: int = 20, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device("cuda" if device is None else device)
        self._env_factory = env_factory
        self.envs = [env_factory(i) for i in range(n_envs)]
        self.n_actions = n_actions
        self.gamma = gamma
        self.lr = lr
        self.value_coef = value_coef
        self.entropy_coef = entropy_coef
        self.t_max = t_max
        self._observe = observe or (lambda i, raw: raw)
        self._rng = np.random.default_rng(seed)
        trunk_init, trunk_apply = trunk
        key = _Key(seed)
        self.params = {"trunk": trunk_init(key, self.device),
                       **_heads_init(key, hidden_size, n_actions,
                                     self.device)}
        self._trunk_apply = trunk_apply
        self._obs = [self._observe(i, e.reset()) for i, e in
                     enumerate(self.envs)]
        self._ep_rew = [0.0] * n_envs
        self.episode_rewards: List[float] = []

    def _heads(self, p, x):
        return _heads_apply(p, self._trunk_apply(p["trunk"], x))

    def _tensor(self, a, dtype=np.float32) -> torch.Tensor:
        return as_tensor(a, dtype, self.device)

    def update(self, obs, actions, returns) -> torch.Tensor:
        """One update from a flattened segment (host arrays or tensors);
        returns the loss as a device scalar, unread."""
        obs, returns = self._tensor(obs), self._tensor(returns)
        actions = self._tensor(actions, np.int64)

        def loss_fn(p):
            logits, values = self._heads(p, obs)
            return _ac_loss(logits, values, actions, returns,
                            self.value_coef, self.entropy_coef,
                            normalize_adv=True)

        return sgd_update(loss_fn, self.params, self.lr)

    def act_batch(self, obs_batch, greedy: bool = False) -> np.ndarray:
        with torch.no_grad():
            logits, _ = self._heads(self.params, self._tensor(obs_batch))
        logits = logits.cpu().numpy()
        if greedy:
            return logits.argmax(axis=1)
        return np.array([self._rng.choice(self.n_actions, p=pr)
                         for pr in _probs(logits)])

    def train_segment(self) -> float:
        """One t_max segment across all envs -> one update (the A3C inner
        loop, synchronous)."""
        n = len(self.envs)
        obs_l = np.zeros((self.t_max, n, *np.shape(self._obs[0])), np.float32)
        act_l = np.zeros((self.t_max, n), np.int32)
        rew_l = np.zeros((self.t_max, n), np.float32)
        done_l = np.zeros((self.t_max, n), np.float32)
        for t in range(self.t_max):
            batch = np.stack(self._obs)
            actions = self.act_batch(batch)
            obs_l[t] = batch
            act_l[t] = actions
            for i, e in enumerate(self.envs):
                raw, r, done = e.step(int(actions[i]))
                rew_l[t, i] = r
                done_l[t, i] = float(done)
                self._ep_rew[i] += r
                if done:
                    self.episode_rewards.append(self._ep_rew[i])
                    self._ep_rew[i] = 0.0
                    raw = e.reset()
                self._obs[i] = self._observe(i, raw)
        # bootstrap unfinished episodes with V(s_T)
        with torch.no_grad():
            _, v_last = self._heads(self.params,
                                    self._tensor(np.stack(self._obs)))
        g = v_last.cpu().numpy()
        returns = np.zeros_like(rew_l)
        for t in range(self.t_max - 1, -1, -1):
            g = rew_l[t] + self.gamma * (1.0 - done_l[t]) * g
            returns[t] = g
        flat = lambda a: a.reshape(self.t_max * n, *a.shape[2:])
        return float(self.update(flat(obs_l), flat(act_l), flat(returns)))

    def train(self, n_segments: int) -> List[float]:
        for _ in range(n_segments):
            self.train_segment()
        return self.episode_rewards

    def play_episode(self, env=None, observe=None) -> float:
        """Greedy rollout on a DEDICATED eval env (factory index n_envs) —
        never a training env, whose (observation, frame-stack) state must
        stay synchronized with the training loop."""
        if env is None:
            idx = len(self.envs)
            env = self._env_factory(idx)
            observe = observe or (lambda raw: self._observe(idx, raw))
        else:
            observe = observe or (lambda raw: raw)
        obs = observe(env.reset())
        total, done = 0.0, False
        while not done:
            a = int(self.act_batch(obs[None], greedy=True)[0])
            raw, r, done = env.step(a)
            obs = observe(raw)
            total += r
        return total


def a3c_dense_trunk(obs_size: int, hidden):
    """(init, apply->hidden) dense trunk for A3CDiscrete."""
    sizes = [obs_size, *hidden]

    def init(key, device):
        return _mlp_init(key, sizes, device)

    def apply(p, x):
        return torch.relu(_mlp_apply(p, x))

    return init, apply


class A3CDiscreteDense(A3CDiscrete):
    """A3CDiscreteDense analog: vector observations, dense trunk."""

    def __init__(self, env_factory, n_envs: int = 8, hidden=(64,),
                 **kwargs):
        probe = env_factory(0)
        # reuse the probe as env 0 (don't construct index 0 twice)
        factory = lambda i: probe if i == 0 else env_factory(i)
        super().__init__(factory, n_envs,
                         a3c_dense_trunk(probe.observation_size, hidden),
                         hidden[-1], probe.n_actions, **kwargs)


class A3CDiscreteConv(A3CDiscrete):
    """A3CDiscreteConv analog: pixel observations through per-env
    HistoryProcessors and the shared conv trunk."""

    def __init__(self, env_factory, history_factory, n_envs: int = 4,
                 channels=(16, 32), dense: int = 128, **kwargs):
        self._hists = {}

        def hist_for(i):
            if i not in self._hists:
                self._hists[i] = history_factory(i)
            return self._hists[i]

        probe = env_factory(0)
        obs_shape = hist_for(0).output_shape

        def observe(i, raw):
            return hist_for(i).observe(raw)

        # wrap env.reset so the frame stack clears whenever its env resets;
        # env 0 reuses the probe (not constructed twice)
        def factory(i):
            env = probe if i == 0 else env_factory(i)
            orig_reset = env.reset
            hist = hist_for(i)

            def reset():
                hist.reset()
                return orig_reset()

            env.reset = reset
            return env

        super().__init__(factory, n_envs, _conv_trunk(obs_shape, channels,
                                                      dense),
                         dense, probe.n_actions, observe=observe, **kwargs)


class A2CDiscreteDense:
    """Episode-rollout A2C over a vector-observation MDP (dense trunk).
    ``device``: the card when None (raising without one), the CPU only
    when asked."""

    def __init__(self, mdp: MDP, hidden: List[int] = (64,),
                 gamma: float = 0.99, lr: float = 7e-3,
                 value_coef: float = 0.5, entropy_coef: float = 0.01,
                 rollout_episodes: int = 4, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device("cuda" if device is None else device)
        self.mdp = mdp
        self.gamma = gamma
        self.lr = lr
        self.value_coef = value_coef
        self.entropy_coef = entropy_coef
        self.rollout_episodes = rollout_episodes
        self._rng = np.random.default_rng(seed)
        key = _Key(seed)
        self.params = {
            "trunk": _mlp_init(key, [mdp.observation_size, *hidden],
                               self.device),
            **_heads_init(key, hidden[-1], mdp.n_actions, self.device)}
        self.episode_rewards: List[float] = []

    def _logits(self, params, obs):
        h = torch.relu(_mlp_apply(params["trunk"], obs))
        return h @ params["pi"]["W"] + params["pi"]["b"]

    def act(self, obs, greedy: bool = False) -> int:
        with torch.no_grad():
            logits = self._logits(self.params, to_device(
                np.asarray(obs, np.float32)[None], self.device))
        logits = logits.cpu().numpy()[0]
        if greedy:
            return int(logits.argmax())
        p = np.exp(logits - logits.max())
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def _rollout(self):
        obs_l, act_l, rew_l = [], [], []
        boundaries = []
        for _ in range(self.rollout_episodes):
            obs = self.mdp.reset()
            done, total = False, 0.0
            while not done:
                a = self.act(obs)
                obs_l.append(obs)
                act_l.append(a)
                next_obs, r, done = self.mdp.step(a)
                rew_l.append(r)
                total += r
                obs = next_obs
            boundaries.append(len(rew_l))
            self.episode_rewards.append(total)
        # discounted returns per episode
        returns = np.zeros(len(rew_l), np.float32)
        start = 0
        for end in boundaries:
            g = 0.0
            for t in range(end - 1, start - 1, -1):
                g = rew_l[t] + self.gamma * g
                returns[t] = g
            start = end
        return (np.asarray(obs_l, np.float32), np.asarray(act_l, np.int32),
                returns)

    def update(self, obs, actions, returns_n) -> torch.Tensor:
        """One update from a rollout (host arrays or tensors; returns
        already normalized); the loss as a device scalar, unread."""
        dev = self.device
        return _a2c_step(self.params, as_tensor(obs, np.float32, dev),
                         as_tensor(actions, np.int64, dev),
                         as_tensor(returns_n, np.float32, dev),
                         self.lr, self.value_coef, self.entropy_coef)

    def train_iteration(self) -> float:
        obs, actions, returns = self._rollout()
        returns_n = (returns - returns.mean()) / (returns.std() + 1e-8)
        return float(self.update(obs, actions, returns_n))

    def train(self, n_iterations: int):
        for _ in range(n_iterations):
            self.train_iteration()
        return self.episode_rewards

    def play_episode(self) -> float:
        obs = self.mdp.reset()
        total, done = 0.0, False
        while not done:
            obs, r, done = self.mdp.step(self.act(obs, greedy=True))
            total += r
        return total
