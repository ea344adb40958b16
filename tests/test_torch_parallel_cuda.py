"""The parallel slice on the card (marked ``cuda``; skipped without one).

Run on the chip with ``python -m pytest -m cuda tests/test_torch_*.py``.
This file imports no JAX: it holds the card's paths against the port's own
plain ones.

- A world-size-1 NCCL group: ``ParallelWrapper`` steps of a conv +
  BatchNorm graph against the same graph's plain ``fit_batch`` from the
  same weights. At one rank every reduction divides by 1, so the steps are
  equal bit for bit.
- The flash ring of 4 replayed on the one card (``replay_ring_flash``: the
  kernels on every rank's blocks with the ring's global lse) against one
  flash call over the whole sequence: o, lse, dq, dk and dv, causal and
  not, with a key-padding mask, each row's ||a - b|| over its ||b|| within
  TOL; the launches of each kernel are the ring's. Two controls must miss
  TOL: the ring's backward given each block's own lse in place of the
  global one, or delta of each block's own o in place of the merged o.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalizationLayer, ConvolutionLayer,
    GlobalPoolingLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
    FLASH_DKV, FLASH_DQ, FLASH_FWD, flash_backward, flash_block_bwd,
    flash_block_fwd, flash_forward,
)
from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
from deeplearning4j_tpu_torch.parallel import (
    DeviceMesh, ParallelWrapper, launch,
)
from deeplearning4j_tpu_torch.parallel import sequence
from deeplearning4j_tpu_torch.parallel.sequence import replay_ring_flash

# each row's ||a - b|| over its ||b|| (no smaller than 1e-3 of the largest
# row's) of the replayed ring's o, lse, dq, dk and dv against one flash
# call; chip_smoke.py's TOL_SEQ
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = prev


def _graph():
    g = (NeuralNetConfiguration.builder().seed(5).updater(Nesterovs(lr=0.05))
         .graph_builder().add_inputs("in")
         .set_input_types(**{"in": InputType.convolutional(16, 16, 3)})
         .add_layer("c1", ConvolutionLayer(n_out=16, kernel=(3, 3),
                                           padding="same", has_bias=False),
                    "in")
         .add_layer("bn1", BatchNormalizationLayer(), "c1")
         .add_layer("r1", ActivationLayer(activation="relu"), "bn1")
         .add_layer("gp", GlobalPoolingLayer(pooling_type="avg"), "r1")
         .add_layer("out", OutputLayer(n_out=4, activation="softmax",
                                       loss="mcxent"), "gp")
         .set_outputs("out").build())
    return ComputationGraph(g).init(device="cuda")


@pytest.mark.cuda
def test_world_of_one_wrapper_step_equals_plain_step(cuda_device):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    plain, wrapped = _graph(), _graph()
    with launch.local_group("cuda"):
        w = ParallelWrapper(wrapped, DeviceMesh(data=1))
        got = [float(w.fit_batch((x, y))) for _ in range(3)]
    want = [float(plain.fit_batch((x, y))) for _ in range(3)]
    assert got == want
    for k in plain.params:
        for n in plain.params[k]:
            assert torch.equal(wrapped.params[k][n], plain.params[k][n])
    for k in plain.state:
        assert torch.equal(wrapped.state[k]["mean"], plain.state[k]["mean"])


def _ring_errors(dtype, causal):
    """The replayed ring of 4 (B 1, H 2, T 512, D 128, keys past 400
    padded) against one flash call: {name: max |a - b| / max |b|}, and
    each kernel's launches in the replay."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, T, D, n = 1, 2, 512, 128, 4
    q, k, v, do = (torch.randn((B, H, T, D), device="cuda", generator=g)
                   .to(dt) for _ in range(4))
    km = torch.ones((B, T), device="cuda")
    km[0, 400:] = 0.0
    scale = 1.0 / math.sqrt(D)
    n0 = FLASH_FWD.launches, FLASH_DQ.launches, FLASH_DKV.launches
    got = replay_ring_flash(q, k, v, size=n, causal=causal, scale=scale,
                            kmask=km, do=do)
    torch.cuda.synchronize()
    launches = (FLASH_FWD.launches - n0[0], FLASH_DQ.launches - n0[1],
                FLASH_DKV.launches - n0[2])
    wo, wlse = flash_forward(q, k, v, scale=scale, causal=causal, kmask=km)
    delta = (do.float() * wo.float()).sum(-1, keepdim=True)
    want = (wo, wlse) + flash_backward(q, k, v, do, wlse, delta, scale=scale,
                                       causal=causal, kmask=km)
    errs = {}
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        den = b.norm(dim=-1)
        den = den.clamp_min(1e-3 * float(den.max()))
        errs[name] = float(((a - b).norm(dim=-1) / den).max())
    return errs, launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_replayed_flash_ring_equals_one_flash_call(cuda_device, dtype,
                                                   causal):
    errs, launches = _ring_errors(dtype, causal)
    blocks = 4 * 5 // 2 if causal else 4 * 4
    assert launches == (blocks, blocks, blocks)
    assert max(errs.values()) <= TOL[dtype], errs


def _block_lse_bwd(q, k, v, do, lse, delta, *, causal, scale, kmask=None):
    kw = dict(causal=causal, scale=scale, kmask=kmask)
    _, own = flash_block_fwd(q, k, v, **kw)
    return flash_block_bwd(q, k, v, do, own, delta, **kw)


def _block_delta_bwd(q, k, v, do, lse, delta, *, causal, scale, kmask=None):
    kw = dict(causal=causal, scale=scale, kmask=kmask)
    o_i, _ = flash_block_fwd(q, k, v, **kw)
    own = (do.float() * o_i.float()).sum(-1, keepdim=True).contiguous()
    return flash_block_bwd(q, k, v, do, lse, own, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [_block_lse_bwd, _block_delta_bwd],
                         ids=["block_lse", "block_delta"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_given_a_block_s_own_lse_or_delta_misses_the_limit(
        cuda_device, monkeypatch, fault, dtype, causal):
    monkeypatch.setattr(sequence, "flash_block_bwd", fault)
    errs, _ = _ring_errors(dtype, causal)
    assert max(errs[k] for k in ("dq", "dk", "dv")) > TOL[dtype], errs
