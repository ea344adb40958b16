"""Reinforcement learning (RL4J equivalent).

Counterpart of ``deeplearning4j_tpu/rl/``, exporting its ``__all__``
whole (and ``load_jax_state``). The environments, the history processor
and the replay buffers are host numpy, copied; the DQN update and the
actor-critic updates are tensor code on the device (``device=None`` is the
card, raising without one; tests pass ``device="cpu"``).

Reference analog: the `rl4j/` module — org.deeplearning4j.rl4j.learning.sync.
qlearning.discrete.QLearningDiscreteDense (DQN with experience replay +
target network), org.deeplearning4j.rl4j.learning.async.a3c.discrete.
A3CDiscreteDense (async advantage actor-critic), MDP contract
(org.deeplearning4j.rl4j.mdp.MDP), ExpReplay.
"""

import numpy as np
import torch

from deeplearning4j_tpu_torch.rl.env import (CartPole, FrameSkipWrapper, MDP,
                                             PixelGridWorld)
from deeplearning4j_tpu_torch.rl.replay import (ExpReplay, FrameStackReplay,
                                                NStepAccumulator)
from deeplearning4j_tpu_torch.rl.history import (HistoryConfiguration,
                                                 HistoryProcessor)
from deeplearning4j_tpu_torch.rl.dqn import (QLearningDiscreteConv,
                                             QLearningDiscreteDense,
                                             clone_tree)
from deeplearning4j_tpu_torch.rl.actor_critic import (A2CDiscreteDense,
                                                      A3CDiscrete,
                                                      A3CDiscreteConv,
                                                      A3CDiscreteDense)

__all__ = ["MDP", "CartPole", "PixelGridWorld", "FrameSkipWrapper",
           "ExpReplay", "FrameStackReplay", "NStepAccumulator", "HistoryProcessor",
           "HistoryConfiguration", "QLearningDiscreteDense",
           "QLearningDiscreteConv", "A2CDiscreteDense",
           "A3CDiscrete", "A3CDiscreteDense", "A3CDiscreteConv",
           "load_jax_state"]


def _like(mine, theirs, where):
    """``theirs`` (a tree of arrays) as f32 tensors on ``mine``'s devices,
    checked key by key and shape by shape against ``mine``."""
    if isinstance(mine, dict):
        if set(mine) != set(theirs):
            raise ValueError(f"{where}: keys {sorted(theirs)} != "
                             f"{sorted(mine)}")
        return {k: _like(mine[k], theirs[k], f"{where}.{k}") for k in mine}
    if isinstance(mine, (list, tuple)):
        if len(mine) != len(theirs):
            raise ValueError(f"{where}: {len(theirs)} entries for "
                             f"{len(mine)}")
        return type(mine)(_like(m, t, f"{where}[{i}]")
                          for i, (m, t) in enumerate(zip(mine, theirs)))
    a = np.asarray(theirs, np.float32)
    if tuple(a.shape) != tuple(mine.shape):
        raise ValueError(f"{where}: shape {a.shape} != {tuple(mine.shape)}")
    return torch.tensor(a, device=mine.device)


def load_jax_state(agent, params, target_params=None, opt_state=None,
                   step: int = 0):
    """Give ``agent`` (a DQN or actor-critic learner of this package) the
    state of the JAX package's: ``params`` is its ``params`` tree as numpy
    (``jax.tree_util.tree_map(np.asarray, jax_agent.params)``); for a DQN,
    ``target_params`` its target net (a copy of ``params`` when None) and
    ``opt_state`` Adam's ``{"m", "v"}`` trees (``jax_agent.opt["state"]``)
    and ``step`` its step counter (``jax_agent.opt["step"]``). The
    counterpart of ``nn.multilayer.load_jax_params`` and
    ``nlp.load_jax_state``."""
    agent.params = _like(agent.params, params, "params")
    if not hasattr(agent, "target_params"):
        if target_params is not None or opt_state is not None:
            raise ValueError(f"{type(agent).__name__} keeps no target net "
                             f"or updater state")
        return agent
    agent.target_params = (clone_tree(agent.params) if target_params is None
                           else _like(agent.params, target_params, "target"))
    state = (agent._updater.init_state(agent.params) if opt_state is None
             else _like(agent.opt["state"], opt_state, "opt_state"))
    agent.opt = {"step": int(step), "state": state}
    return agent
