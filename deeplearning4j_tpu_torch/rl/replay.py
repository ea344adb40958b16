"""Experience replay buffer.

Counterpart of ``deeplearning4j_tpu/rl/replay.py``, copied (host numpy, no
framework): the same seeds give the same draws.

Reference analog: org.deeplearning4j.rl4j.learning.sync.ExpReplay — circular
transition store with uniform minibatch sampling. Generalized here to
arbitrary observation shapes (dense vectors or stacked pixel frames), plus
an n-step transition accumulator (the AsyncNStepQLearning reward-accumulation
idea as a synchronous, replay-compatible component).
"""

from __future__ import annotations

from collections import deque
from typing import Tuple, Union

import numpy as np


class ExpReplay:
    def __init__(self, capacity: int, obs_size: Union[int, Tuple[int, ...]],
                 seed: int = 0):
        obs_shape = (obs_size,) if isinstance(obs_size, int) else obs_size
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self.obs = np.zeros((capacity, *obs_shape), np.float32)
        self.next_obs = np.zeros((capacity, *obs_shape), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self._n = 0
        self._pos = 0

    def __len__(self):
        return self._n

    def store(self, obs, action, reward, next_obs, done):
        i = self._pos
        self.obs[i] = obs
        self.actions[i] = action
        self.rewards[i] = reward
        self.next_obs[i] = next_obs
        self.dones[i] = float(done)
        self._pos = (self._pos + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)

    def sample(self, batch_size: int) -> Tuple[np.ndarray, ...]:
        idx = self._rng.integers(0, self._n, size=batch_size)
        return (self.obs[idx], self.actions[idx], self.rewards[idx],
                self.next_obs[idx], self.dones[idx])


class FrameStackReplay:
    """Frame-ring replay for pixel observations: each raw processed frame is
    stored ONCE and observation stacks are reassembled at sample time — the
    DQN-Nature memory layout. A stacked [H, W, k] float32 store duplicates
    every frame 2k times; this keeps one copy per step (plus one terminal
    frame per episode), cutting pixel replay memory ~8x at history 4.

    Drop-in for ExpReplay in the conv trainer: ``store`` takes the SAME
    (obs_stack, action, reward, next_stack, done) arguments and strips the
    newest frame from each stack internally; ``sample`` returns stacked
    [B, H, W, k] observations identical to what was stored.

    n-step returns are computed AT SAMPLE TIME from the stored per-step
    rewards (pass ``n_step``/``gamma``) rather than via NStepAccumulator —
    an accumulator in front of a frame ring would store obs_t's frame but
    pair it with a pre-summed reward whose true successor is s_{t+n}, while
    the ring's adjacency reconstructs s_{t+1}: silently wrong targets. The
    trainer still bootstraps with gamma**n_step; episode ends shorten the
    window (done inside the window => no bootstrap, same as the reference's
    episode-boundary flush).

    ``frame_dtype``: np.float32 default; pass np.uint8 for byte-valued
    frames (ALE-style) to cut memory another 4x.
    """

    #: n-step semantics live inside this buffer; the trainer must NOT wrap
    #: it in an NStepAccumulator
    handles_n_step = True

    def __init__(self, capacity, frame_shape, history_length: int,
                 seed: int = 0, frame_dtype=np.float32, n_step: int = 1,
                 gamma: float = 0.99):
        if n_step < 1:
            raise ValueError("n_step must be >= 1")
        self.capacity = capacity
        self.k = history_length
        self.n_step = n_step
        self.gamma = gamma
        self._rng = np.random.default_rng(seed)
        self.frames = np.zeros((capacity, *frame_shape), frame_dtype)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        # per-slot episode id and step-within-episode; has_transition is
        # False for the extra terminal-frame slot pushed at episode end
        self.ep = np.full(capacity, -1, np.int64)
        self.t_in_ep = np.zeros(capacity, np.int64)
        self.has_transition = np.zeros(capacity, bool)
        self._pos = 0
        self._n = 0
        self._ep_id = 0
        self._new_episode = True
        self._count = 0  # transitions stored

    def __len__(self):
        return self._count

    def _push(self, frame, ep, t, action=0, reward=0.0, done=False,
              has_transition=False):
        i = self._pos
        if self.has_transition[i]:
            self._count -= 1          # overwriting an old transition
        self.frames[i] = frame
        self.actions[i] = action
        self.rewards[i] = reward
        self.dones[i] = float(done)
        self.ep[i] = ep
        self.t_in_ep[i] = t
        self.has_transition[i] = has_transition
        self._pos = (self._pos + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)
        if has_transition:
            self._count += 1

    def store(self, obs, action, reward, next_obs, done):
        f_t = np.asarray(obs)[..., -1]
        t = 0 if self._new_episode else self._t_next
        self._push(f_t, self._ep_id, t, action, reward, done,
                   has_transition=True)
        self._new_episode = False
        self._t_next = t + 1
        if done:
            # terminal frame slot so the last transition's next-stack exists
            self._push(np.asarray(next_obs)[..., -1], self._ep_id, t + 1)
            self._ep_id += 1
            self._new_episode = True

    def _stack_ending_at(self, i):
        """[H, W, k] stack whose newest frame is slot i, left-padded by
        repeating the earliest same-episode frame."""
        idxs = [i]
        cur = i
        for _ in range(self.k - 1):
            prev = (cur - 1) % self.capacity
            if (self._n == self.capacity or prev < cur) and \
               self.ep[prev] == self.ep[cur] and \
               self.t_in_ep[prev] == self.t_in_ep[cur] - 1:
                idxs.append(prev)
                cur = prev
            else:
                idxs.append(cur)      # repeat earliest episode frame
        idxs.reverse()
        return np.stack([self.frames[j].astype(np.float32) for j in idxs],
                        axis=-1)

    def _succ_ok(self, i, j):
        """Slot (i+j) % capacity still holds this episode's step t_i + j."""
        s = (i + j) % self.capacity
        return (self.ep[s] == self.ep[i]
                and self.t_in_ep[s] == self.t_in_ep[i] + j)

    def _history_ok(self, i):
        """The frames the obs stack at slot i needs must have SURVIVED the
        ring: walk back min(k-1, t_in_ep) steps requiring the consecutive
        same-episode chain (repeat-padding is only legitimate at episode
        starts, where the missing history never existed)."""
        back = min(self.k - 1, int(self.t_in_ep[i]))
        cur = i
        for _ in range(back):
            prev = (cur - 1) % self.capacity
            if not (self.ep[prev] == self.ep[cur]
                    and self.t_in_ep[prev] == self.t_in_ep[cur] - 1):
                return False
            cur = prev
        return True

    def _window(self, i):
        """n-step window starting at transition slot i: returns
        (G, next_slot, done) or None if any needed slot was overwritten.
        The window shortens at episode end (done inside => no bootstrap)."""
        g = 0.0
        for j in range(self.n_step):
            s = (i + j) % self.capacity
            if not (self._succ_ok(i, j) and self.has_transition[s]):
                return None
            g += (self.gamma ** j) * float(self.rewards[s])
            if self.dones[s]:
                nxt = (i + j + 1) % self.capacity
                return (g, nxt, 1.0) if self._succ_ok(i, j + 1) else None
        nxt = (i + self.n_step) % self.capacity
        return (g, nxt, 0.0) if self._succ_ok(i, self.n_step) else None

    def sample(self, batch_size: int) -> Tuple[np.ndarray, ...]:
        obs, actions, rewards, next_obs, dones = [], [], [], [], []
        tries = 0
        while len(obs) < batch_size:
            i = int(self._rng.integers(0, self._n))
            tries += 1
            if tries > 200 * batch_size:
                raise RuntimeError("FrameStackReplay: not enough valid "
                                   "transitions to sample from")
            if not (self.has_transition[i] and self._history_ok(i)):
                continue
            win = self._window(i)
            if win is None or not self._history_ok(win[1]):
                continue
            g, nxt, done = win
            obs.append(self._stack_ending_at(i))
            next_obs.append(self._stack_ending_at(nxt))
            actions.append(self.actions[i])
            rewards.append(g)
            dones.append(done)
        return (np.stack(obs), np.asarray(actions, np.int32),
                np.asarray(rewards, np.float32), np.stack(next_obs),
                np.asarray(dones, np.float32))


class NStepAccumulator:
    """Converts 1-step transitions into n-step ones before replay storage.

    Emitted transitions are (obs_t, a_t, sum_{k=0..n-1} gamma^k r_{t+k},
    obs_{t+n}, done); the TD backup then bootstraps with gamma^n (the
    trainer owns that exponent). On episode end, all pending transitions
    flush with their shortened-horizon returns, matching the reference's
    n-step accumulation at episode boundaries.
    """

    def __init__(self, replay: ExpReplay, n_step: int, gamma: float):
        if n_step < 1:
            raise ValueError("n_step must be >= 1")
        self.replay = replay
        self.n_step = n_step
        self.gamma = gamma
        self._pending: deque = deque()

    def store(self, obs, action, reward, next_obs, done):
        self._pending.append([obs, action, 0.0, 0, next_obs, done])
        # fold this reward into every pending transition's partial return
        for entry in self._pending:
            entry[2] += (self.gamma ** entry[3]) * reward
            entry[3] += 1
            entry[4] = next_obs
            entry[5] = done
        while self._pending and (self._pending[0][3] >= self.n_step or done):
            o, a, g, _, no, d = self._pending.popleft()
            self.replay.store(o, a, g, no, d)
        if done:
            self._pending.clear()

    def sample(self, batch_size: int) -> Tuple[np.ndarray, ...]:
        return self.replay.sample(batch_size)

    def __len__(self):
        return len(self.replay)
