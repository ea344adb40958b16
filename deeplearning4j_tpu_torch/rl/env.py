"""MDP contract + CartPole.

Counterpart of ``deeplearning4j_tpu/rl/env.py``, copied (host numpy, no
framework): the same seeds give the same draws.

Reference analog: org.deeplearning4j.rl4j.mdp.MDP (reset/step/isDone,
observation/action spaces) and the gym bridge the reference uses for
CartPole-v0 — re-implemented here in numpy (no egress, no gym).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


class MDP:
    observation_size: int
    n_actions: int

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        """-> (observation, reward, done)"""
        raise NotImplementedError


class FrameSkipWrapper(MDP):
    """Action-repeat wrapper (the reference's skipFrame semantics): each
    agent-visible step repeats the action ``skip`` times, summing rewards."""

    def __init__(self, mdp: MDP, skip: int):
        if skip < 1:
            raise ValueError("skip must be >= 1")
        self.mdp = mdp
        self.skip = skip
        self.observation_size = getattr(mdp, "observation_size", None)
        self.n_actions = mdp.n_actions

    def reset(self):
        return self.mdp.reset()

    def step(self, action: int):
        total, done = 0.0, False
        obs = None
        for _ in range(self.skip):
            obs, r, done = self.mdp.step(action)
            total += r
            if done:
                break
        return obs, total, done


class PixelGridWorld(MDP):
    """Tiny pixel-observation MDP for conv Q-learning tests: the agent is a
    bright pixel on a dark [size, size] frame, actions move it left/right
    along the middle row, reaching the right edge pays +1 and ends the
    episode (a no-egress stand-in for the reference's ALE/Malmo pixel MDPs).
    """

    def __init__(self, size: int = 12, max_steps: int = 40, seed: int = 0):
        self.size = size
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self.n_actions = 2
        self._pos = 0
        self._steps = 0

    @property
    def frame_shape(self):
        return (self.size, self.size)

    def _frame(self) -> np.ndarray:
        f = np.zeros((self.size, self.size), np.float32)
        f[self.size // 2, self._pos] = 1.0
        return f

    def reset(self) -> np.ndarray:
        self._pos = int(self._rng.integers(0, self.size // 2))
        self._steps = 0
        return self._frame()

    def step(self, action: int):
        self._pos = min(self.size - 1, max(0, self._pos + (1 if action == 1
                                                           else -1)))
        self._steps += 1
        reached = self._pos == self.size - 1
        done = reached or self._steps >= self.max_steps
        return self._frame(), (1.0 if reached else -0.01), done


class CartPole(MDP):
    """Classic cart-pole balancing (the CartPole-v0 dynamics)."""

    observation_size = 4
    n_actions = 2

    def __init__(self, seed: int = 0, max_steps: int = 200):
        self._rng = np.random.default_rng(seed)
        self.max_steps = max_steps
        self.gravity = 9.8
        self.masscart, self.masspole = 1.0, 0.1
        self.length = 0.5  # half pole length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        self.state = np.zeros(4)
        self._steps = 0

    def reset(self) -> np.ndarray:
        self.state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self.state.astype(np.float32).copy()

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costh, sinth = math.cos(theta), math.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot ** 2 * sinth) / total_mass
        theta_acc = (self.gravity * sinth - costh * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costh ** 2 / total_mass))
        x_acc = temp - polemass_length * theta_acc * costh / total_mass
        x += self.tau * x_dot
        x_dot += self.tau * x_acc
        theta += self.tau * theta_dot
        theta_dot += self.tau * theta_acc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        done = bool(abs(x) > self.x_threshold
                    or abs(theta) > self.theta_threshold
                    or self._steps >= self.max_steps)
        return self.state.astype(np.float32).copy(), 1.0, done
