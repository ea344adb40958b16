"""Where a DQN environment step's host time goes on the card: phase 45's
conv learner (DQN-Nature widths, 84 x 84 x 4) and the CartPole dense
learner, each after its replay fills. Times (synced, ms a call) the
frame ring's sample, the staging of a [32, 84, 84, 4] batch (pinned, as
``common.device.to_device`` does, and pageable), the update from host
arrays and from staged tensors, a greedy act, and the training loop's
steps a second, with a cProfile of the loop's top functions. Run from the
root of a checkout on a machine with the card:

    python3 experiments/learners/dqn_host_split.py

One JSON line a learner, and the profiles as text.
"""

import cProfile
import io
import json
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.common.device import to_device  # noqa: E402
from deeplearning4j_tpu_torch.rl import (  # noqa: E402
    CartPole, HistoryProcessor, PixelGridWorld, QLearningDiscreteConv,
    QLearningDiscreteDense,
)


def timed(fn, n=50):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def split(name, agent, fill):
    while agent.step_count < fill:
        agent.train_episode()
    batch = agent.replay.sample(agent.batch_size)
    dev = [to_device(np.asarray(a, np.int64 if i == 1 else np.float32),
                     agent.device) for i, a in enumerate(batch)]
    obs = np.asarray(batch[0])
    out = {
        "sample_ms": timed(lambda: agent.replay.sample(agent.batch_size)),
        "stage_pinned_ms": timed(lambda: to_device(obs, agent.device)),
        "stage_pageable_ms": timed(
            lambda: torch.from_numpy(obs).to(agent.device)),
        "update_host_arrays_ms": timed(lambda: agent.update(*batch)),
        "update_staged_ms": timed(lambda: agent.update(*dev)),
        "act_greedy_ms": timed(lambda: agent.act(obs[0], greedy=True)),
    }
    prof = cProfile.Profile()
    steps0 = agent.step_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    while agent.step_count < steps0 + 300:
        agent.train_episode()
    prof.disable()
    torch.cuda.synchronize()
    out["loop_env_steps_per_s"] = (agent.step_count - steps0) / (
        time.perf_counter() - t0)
    print(json.dumps({name: out}), flush=True)
    s = io.StringIO()
    pstats.Stats(prof, stream=s).sort_stats("tottime").print_stats(20)
    print(s.getvalue()[-6000:], flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("card:", cs.card_line(), flush=True)
    split("conv", QLearningDiscreteConv(
        PixelGridWorld(size=cs.DQN_FRAME, seed=0),
        HistoryProcessor(history_length=cs.DQN_HISTORY).set_input_shape(
            cs.DQN_FRAME, cs.DQN_FRAME), seed=0, device="cuda",
        **cs.DQN_CONV), cs.DQN_CONV["min_replay"] + 50)
    split("dense", QLearningDiscreteDense(CartPole(seed=0), seed=0,
                                          device="cuda"), 250)


if __name__ == "__main__":
    main()
