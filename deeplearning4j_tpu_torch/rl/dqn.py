"""DQN — Q-learning with replay and target network.

Counterpart of ``deeplearning4j_tpu/rl/dqn.py``: the same Q-nets under the
same parameter tree (``trunk`` / ``conv`` / ``dense``, ``q`` or
``adv`` + ``val``, each ``{"W", "b"}``, dense W [in, out], conv W HWIO), the
same update and the same host policy, so weights and Adam state carry
across (``rl.load_jax_state``) and the same weights and seed take the same
actions.

Reference analog: org.deeplearning4j.rl4j.learning.sync.qlearning.discrete.
QLearningDiscreteDense / QLearningDiscreteConv + QLConfiguration
(epsilon-greedy with annealing, errorClamp, targetDqnUpdateFreq, doubleDQN
flag), with the dueling-architecture and n-step-return options of the era's
DQN lineage.

The update (``dqn_update``) is one function of tensors on the device: the
online and target forwards, the double-DQN argmax and gather, Huber at
``error_clamp``, ``autograd.grad`` and the port's Adam, the params updated
in place. It never reads a value back to the host; the step counter is a
host int, as the JAX package's is a traced scalar. The target net is a
copy of the online one (``clone``), never an alias: the in-place update
would otherwise move it too. The conv trunk is 3x3 stride-2 SAME in NHWC
through ``ops.convolution.conv2d`` (XLA's SAME: the odd pad at the end).

Initial weights come from torch generators (``_Key``: a seed and the JAX
package's fold-in path, drawn on the CPU), not threefry: the two packages'
fresh agents differ; ``load_jax_state`` gives the port the JAX agent's.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.device import (
    DeviceLike, resolve_device, to_device,
)
from deeplearning4j_tpu_torch.common.trees import (
    tree_leaves, tree_map, tree_unflatten,
)
from deeplearning4j_tpu_torch.ops.convolution import conv2d
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.rl.env import MDP
from deeplearning4j_tpu_torch.rl.replay import (
    ExpReplay, FrameStackReplay, NStepAccumulator,
)


class _Key:
    """A seed and a fold-in path, standing where the JAX package passes a
    threefry key: ``fold_in`` and ``split`` extend the path, ``normal``
    draws from a CPU torch generator seeded by (seed, path) and moves the
    draw to ``device``, so the card and the CPU start from the same
    weights."""

    def __init__(self, seed: int, path: Tuple[int, ...] = ()):
        self.seed, self.path = int(seed), tuple(path)

    def fold_in(self, i: int) -> "_Key":
        return _Key(self.seed, self.path + (int(i),))

    def split(self) -> Tuple["_Key", "_Key"]:
        return self.fold_in(1 << 31), self.fold_in((1 << 31) + 1)

    def normal(self, shape, device) -> torch.Tensor:
        state = np.random.SeedSequence(
            [self.seed & 0xFFFFFFFF, *self.path]).generate_state(2)
        g = torch.Generator().manual_seed(
            (int(state[0]) | (int(state[1]) << 32)) & ((1 << 63) - 1))
        return torch.randn(tuple(shape), generator=g).to(device)


def _mlp_init(key: _Key, sizes, device):
    params = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = key.fold_in(i).normal((a, b), device) * math.sqrt(2.0 / a)
        params.append({"W": w, "b": torch.zeros(b, device=device)})
    return params


def _mlp_apply(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["W"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def _dense_net(obs_size: int, hidden: Sequence[int], n_actions: int,
               dueling: bool):
    """(init, apply) for the dense Q-net; apply returns [B, A] Q-values."""

    def init(key, device):
        trunk = _mlp_init(key, [obs_size, *hidden], device)
        heads = _dueling_heads_init(key.fold_in(1000), hidden[-1],
                                    n_actions, dueling, device)
        return {"trunk": trunk, **heads}

    def apply(p, x):
        h = torch.relu(_mlp_apply(p["trunk"], x))
        return _dueling_heads_apply(p, h, dueling)

    return init, apply


def _conv_trunk(obs_shape: Tuple[int, int, int], channels: Sequence[int],
                dense: int):
    """(init, apply) for a pixel trunk: 3x3 stride-2 SAME conv stack (NHWC)
    -> flatten -> dense -> hidden vector. Shared by the conv DQN and the
    A3C-analog actor-critic."""

    def init(key, device):
        params = {"conv": []}
        c_in = obs_shape[-1]
        h, w = obs_shape[0], obs_shape[1]
        for i, c_out in enumerate(channels):
            fan_in = 3 * 3 * c_in
            params["conv"].append({
                "W": key.fold_in(i).normal((3, 3, c_in, c_out), device)
                * math.sqrt(2.0 / fan_in),
                "b": torch.zeros(c_out, device=device)})
            c_in = c_out
            h, w = (h + 1) // 2, (w + 1) // 2
        flat = h * w * c_in
        params["dense"] = {
            "W": key.fold_in(500).normal((flat, dense), device)
            * math.sqrt(2.0 / flat),
            "b": torch.zeros(dense, device=device)}
        return params

    def apply(p, x):
        for layer in p["conv"]:
            x = conv2d(x, layer["W"], strides=(2, 2), padding="same") \
                + layer["b"]
            x = torch.relu(x)
        x = x.reshape(x.shape[0], -1)
        return torch.relu(x @ p["dense"]["W"] + p["dense"]["b"])

    return init, apply


def _conv_net(obs_shape: Tuple[int, int, int], channels: Sequence[int],
              dense: int, n_actions: int, dueling: bool):
    """(init, apply) for the pixel Q-net: conv trunk -> Q heads."""
    trunk_init, trunk_apply = _conv_trunk(obs_shape, channels, dense)

    def init(key, device):
        params = trunk_init(key, device)
        params.update(_dueling_heads_init(key.fold_in(1000), dense,
                                          n_actions, dueling, device))
        return params

    def apply(p, x):
        return _dueling_heads_apply(p, trunk_apply(p, x), dueling)

    return init, apply


def _dueling_heads_init(key: _Key, h: int, n_actions: int, dueling: bool,
                        device):
    k1, k2 = key.split()
    zeros = lambda n: torch.zeros(n, device=device)
    if not dueling:
        return {"q": {"W": k1.normal((h, n_actions), device)
                      * math.sqrt(2.0 / h), "b": zeros(n_actions)}}
    return {"adv": {"W": k1.normal((h, n_actions), device) * 0.01,
                    "b": zeros(n_actions)},
            "val": {"W": k2.normal((h, 1), device) * 0.01, "b": zeros(1)}}


def _dueling_heads_apply(p, h, dueling: bool):
    if not dueling:
        return h @ p["q"]["W"] + p["q"]["b"]
    adv = h @ p["adv"]["W"] + p["adv"]["b"]
    val = h @ p["val"]["W"] + p["val"]["b"]
    # Q = V + A - mean(A): the identifiability constraint from the dueling
    # architecture; without it V/A are only determined up to a constant
    return val + adv - adv.mean(dim=1, keepdim=True)


def as_tensor(a, dtype, device) -> torch.Tensor:
    """``a`` (host array or tensor) as a ``dtype`` tensor on ``device``;
    host arrays go through ``to_device`` (pinned staging)."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.int64 if dtype == np.int64
                    else torch.float32)
    return to_device(np.asarray(a, dtype), device)


def clone_tree(tree):
    """A copy of every tensor of ``tree`` (the target net: never an
    alias of the params the update writes in place)."""
    return tree_map(lambda a: a.detach().clone(), tree)


def grads_of(loss_fn, params):
    """(loss, grads) of ``loss_fn(params)``: ``jax.value_and_grad`` over a
    tree of plain tensors, which stay untouched."""
    leaves = [a.detach().requires_grad_(True) for a in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


@torch.no_grad()
def _subtract_(params, updates):
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.sub_(u)


def dqn_update(apply, params, opt, target_params, obs, actions, rewards,
               next_obs, dones, *, gamma_n: float, double_dqn: bool,
               error_clamp: float, updater):
    """One DQN update on device tensors: ``params`` (and Adam's moments in
    ``opt["state"]``) change in place; returns (opt, loss). ``actions`` are
    int64 indices; ``gamma_n`` is gamma ** n_step (the rewards inside the
    window are pre-summed)."""
    idx = actions[:, None]

    def loss_fn(p):
        q = apply(p, obs)                                       # [B, A]
        q_sa = torch.gather(q, 1, idx)[:, 0]
        with torch.no_grad():  # the target side carries no gradient
            q_next_t = apply(target_params, next_obs)
            if double_dqn:
                a_star = torch.argmax(apply(p, next_obs), dim=1)
                q_next = torch.gather(q_next_t, 1, a_star[:, None])[:, 0]
            else:
                q_next = q_next_t.max(dim=1).values
        target = rewards + gamma_n * (1.0 - dones) * q_next
        td = q_sa - target
        if error_clamp > 0:  # Huber (the reference's errorClamp)
            abs_td = td.abs()
            loss = torch.where(abs_td <= error_clamp, 0.5 * td ** 2,
                               error_clamp * (abs_td - 0.5 * error_clamp))
        else:
            loss = 0.5 * td ** 2
        return loss.mean()

    loss, grads = grads_of(loss_fn, params)
    with torch.no_grad():
        upd, new_state = updater.update(grads, opt["state"], params,
                                        opt["step"])
    _subtract_(params, upd)
    return {"step": opt["step"] + 1, "state": new_state}, loss


class _QLearningDiscrete:
    """Shared DQN machinery; subclasses provide the Q-network."""

    def __init__(self, mdp: MDP, net, obs_shape, gamma: float, lr: float,
                 batch_size: int, replay_capacity: int, min_replay: int,
                 target_update_freq: int, eps_start: float, eps_end: float,
                 eps_decay_steps: int, double_dqn: bool, error_clamp: float,
                 n_step: int, seed: int, device: DeviceLike = None):
        init, apply = net
        self.device = resolve_device("cuda" if device is None else device)
        self.mdp = mdp
        self.gamma = gamma
        self.lr = lr
        self.batch_size = batch_size
        self.min_replay = min_replay
        self.target_update_freq = target_update_freq
        self.eps_start, self.eps_end = eps_start, eps_end
        self.eps_decay_steps = eps_decay_steps
        self.double_dqn = double_dqn
        self.error_clamp = error_clamp
        self.n_step = n_step
        self._rng = np.random.default_rng(seed)
        self._apply = apply
        self.params = init(_Key(seed), self.device)
        self.target_params = clone_tree(self.params)
        self._updater = Adam(lr=lr)
        self.opt = {"step": 0,
                    "state": self._updater.init_state(self.params)}
        replay = self._make_buffer(replay_capacity, obs_shape, seed)
        if n_step == 1 or getattr(replay, "handles_n_step", False):
            # frame-ring buffers own their n-step window (an accumulator in
            # front would pair pre-summed rewards with the WRONG ring
            # successor) — see FrameStackReplay
            self.replay = replay
        else:
            self.replay = NStepAccumulator(replay, n_step, gamma)
        self.step_count = 0
        self.episode_rewards: List[float] = []

    def _make_buffer(self, capacity, obs_shape, seed):
        return ExpReplay(capacity, obs_shape, seed)

    def q_values(self, obs) -> torch.Tensor:
        """[B, A] Q-values of a host or device batch of observations."""
        with torch.no_grad():
            return self._apply(self.params, self._tensor(obs))

    def _tensor(self, a, dtype=np.float32) -> torch.Tensor:
        return as_tensor(a, dtype, self.device)

    def update(self, obs, actions, rewards, next_obs, dones) -> torch.Tensor:
        """One update from a sampled batch (host arrays or tensors);
        returns the loss as a device scalar, unread."""
        self.opt, loss = dqn_update(
            self._apply, self.params, self.opt, self.target_params,
            self._tensor(obs), self._tensor(actions, np.int64),
            self._tensor(rewards), self._tensor(next_obs),
            self._tensor(dones), gamma_n=self.gamma ** self.n_step,
            double_dqn=self.double_dqn, error_clamp=self.error_clamp,
            updater=self._updater)
        return loss

    # ---------------------------------------------------------------- policy
    def epsilon(self) -> float:
        frac = min(1.0, self.step_count / self.eps_decay_steps)
        return self.eps_start + frac * (self.eps_end - self.eps_start)

    def _observe(self, obs: np.ndarray) -> np.ndarray:
        return obs

    def act(self, obs: np.ndarray, greedy: bool = False) -> int:
        if not greedy and self._rng.random() < self.epsilon():
            return int(self._rng.integers(self.mdp.n_actions))
        q = self.q_values(np.asarray(obs)[None])
        return int(torch.argmax(q[0]))

    # ----------------------------------------------------------------- train
    def train_episode(self) -> float:
        raw = self.mdp.reset()
        obs = self._observe(raw)
        total = 0.0
        done = False
        while not done:
            a = self.act(obs)
            raw, r, done = self.mdp.step(a)
            next_obs = self._observe(raw)
            self.replay.store(obs, a, r, next_obs, done)
            obs = next_obs
            total += r
            self.step_count += 1
            if len(self.replay) >= self.min_replay:
                self.update(*self.replay.sample(self.batch_size))
            if self.step_count % self.target_update_freq == 0:
                self.target_params = clone_tree(self.params)
        self.episode_rewards.append(total)
        return total

    def train(self, n_episodes: int) -> List[float]:
        return [self.train_episode() for _ in range(n_episodes)]

    def play_episode(self) -> float:
        """Greedy rollout (Policy.play analog)."""
        raw = self.mdp.reset()
        obs = self._observe(raw)
        total, done = 0.0, False
        while not done:
            raw, r, done = self.mdp.step(self.act(obs, greedy=True))
            obs = self._observe(raw)
            total += r
        return total


class QLearningDiscreteDense(_QLearningDiscrete):
    """DQN trainer over a vector-observation MDP."""

    def __init__(self, mdp: MDP, hidden: List[int] = (64, 64),
                 gamma: float = 0.99, lr: float = 1e-3,
                 batch_size: int = 64, replay_capacity: int = 10000,
                 min_replay: int = 200, target_update_freq: int = 100,
                 eps_start: float = 1.0, eps_end: float = 0.05,
                 eps_decay_steps: int = 2000, double_dqn: bool = True,
                 error_clamp: float = 1.0, dueling: bool = False,
                 n_step: int = 1, seed: int = 0, device: DeviceLike = None):
        net = _dense_net(mdp.observation_size, list(hidden), mdp.n_actions,
                         dueling)
        super().__init__(mdp, net, mdp.observation_size, gamma, lr,
                         batch_size, replay_capacity, min_replay,
                         target_update_freq, eps_start, eps_end,
                         eps_decay_steps, double_dqn, error_clamp, n_step,
                         seed, device)


class QLearningDiscreteConv(_QLearningDiscrete):
    """DQN trainer over pixel observations through a HistoryProcessor
    (QLearningDiscreteConv + IHistoryProcessor analog): raw frames are
    rescaled/stacked host-side, the stacked [H, W, history] tensor is the
    Q-net input."""

    def __init__(self, mdp: MDP, history_processor,
                 channels: Sequence[int] = (16, 32), dense: int = 128,
                 gamma: float = 0.99, lr: float = 1e-3,
                 batch_size: int = 32, replay_capacity: int = 5000,
                 min_replay: int = 100, target_update_freq: int = 100,
                 eps_start: float = 1.0, eps_end: float = 0.05,
                 eps_decay_steps: int = 2000, double_dqn: bool = True,
                 error_clamp: float = 1.0, dueling: bool = False,
                 n_step: int = 1, seed: int = 0, device: DeviceLike = None):
        self.history = history_processor
        obs_shape = history_processor.output_shape
        net = _conv_net(obs_shape, list(channels), dense, mdp.n_actions,
                        dueling)
        super().__init__(mdp, net, obs_shape, gamma, lr, batch_size,
                         replay_capacity, min_replay, target_update_freq,
                         eps_start, eps_end, eps_decay_steps, double_dqn,
                         error_clamp, n_step, seed, device)

    def _make_buffer(self, capacity, obs_shape, seed):
        # frame-ring store: one copy per raw frame instead of 2*history
        # stacked copies per transition (the DQN-Nature replay layout);
        # n-step windows are computed inside the ring at sample time
        return FrameStackReplay(capacity, obs_shape[:-1], obs_shape[-1], seed,
                                n_step=self.n_step, gamma=self.gamma)

    def _observe(self, obs: np.ndarray) -> np.ndarray:
        return self.history.observe(obs)

    def train_episode(self) -> float:
        self.history.reset()
        return super().train_episode()

    def play_episode(self) -> float:
        self.history.reset()
        return super().play_episode()
