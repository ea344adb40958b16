"""The port's sequence parallelism (``parallel/sequence.py``) against the
JAX package's.

One gloo world of 4 ranks on a (data 1, seq 4) mesh computes every case
(``torch_parallel_ranks.sequence_world``); the JAX side runs its
``shard_map`` versions on a (data 2, seq 4) mesh of the conftest's 8
virtual devices. Tolerances: forward 2e-5 and gradients 5e-5 absolute
(2e-4 relative) in f32, as the JAX tests state them; the encoder block 1e-4
(1e-3 relative).

- ``ring_attention`` on both cores, causal and not, with a key-padding
  mask whose second shard is all masked, forward and the gradients of
  ``sum(out * do)``, against the JAX einsum ring; the flash core (the
  flash kernels' plain versions on the CPU) is the same function, and its
  blocks equal a one-device replay of the ring (``replay_ring_flash``) bit
  for bit. The JAX flash ring runs the Pallas kernels in interpret mode at
  35-40 s a case here, so its contract is held where the ring uses it:
  the block primitives with an external lse, port against JAX, at one
  block (``TestRingFlashCore``).
- Ulysses, the sequence-parallel encoder (ring, Ulysses, zig-zag), the
  zig-zag ring (natural and pre-permuted order), long context, the guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers.attention import (
    TransformerEncoderLayer as JaxEncoder,
)
from deeplearning4j_tpu.ops.attention import dot_product_attention as jax_dpa
from deeplearning4j_tpu.parallel import DeviceMesh as JaxMesh
from deeplearning4j_tpu.parallel import sequence as jseq
from deeplearning4j_tpu_torch.ops.cuda.flash_attention import kernel_admits
from deeplearning4j_tpu_torch.parallel import launch
from deeplearning4j_tpu_torch.parallel import sequence as pseq

import torch_parallel_ranks as ranks

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=5e-5)
ENC = dict(rtol=1e-3, atol=1e-4)


def _inputs():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    qkvd = [f(2, 2, 32, 8) for _ in range(4)]
    mask = np.ones((2, 32), np.float32)
    mask[0, 20:] = 0.0      # trailing pad across a shard boundary
    mask[1, 8:16] = 0.0     # a whole shard masked out
    heads = [f(2, 4, 32, 4) for _ in range(3)]
    long = [f(1, 2, 1024, 16) for _ in range(3)]
    layer = JaxEncoder(d_model=16, n_heads=4, causal=True)
    enc_params, _ = layer.init(jax.random.key(0),
                               JaxInputType.recurrent(16, 32))
    enc_x = f(2, 32, 16) * 0.5
    return dict(qkvd=qkvd, mask=mask, heads=heads, long=long,
                enc_params=jax.tree_util.tree_map(np.asarray, enc_params),
                enc_x=enc_x, enc_heads=4)


@pytest.fixture(scope="module")
def case():
    p = _inputs()
    mesh = JaxMesh(data=2, seq=4)
    p["enc_xz"] = np.asarray(jseq.zigzag_shard(jnp.asarray(p["enc_x"]),
                                               mesh.mesh, seq_axis=1))
    port = launch.run(ranks.sequence_world, 4, device="cpu", args=(p,),
                      threads=1, timeout=300)
    return p, mesh, port


def _jax_grads(fn, *xs, do=None):
    """(fn(*xs), the gradients of sum(fn * do)), jitted (shard_map run op
    by op is slow)."""
    xs = [jnp.asarray(x) for x in xs]
    w = None if do is None else jnp.asarray(do)

    def value_and_grads(*a):
        out = fn(*a)
        def loss(*b):
            return (fn(*b) * (1.0 if w is None else w)).sum()

        return out, jax.grad(loss, argnums=tuple(range(len(a))))(*a)

    out, g = jax.jit(value_and_grads)(*xs)
    return np.asarray(out), [np.asarray(t) for t in g]


def _check(got, want, fwd=FWD, grad=GRAD):
    np.testing.assert_allclose(got[0], want[0], **fwd)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, **grad)


class TestRingAttention:
    @pytest.mark.parametrize("impl", ["einsum", "flash"])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("masked", [False, True])
    def test_ring_matches_jax(self, case, impl, causal, masked):
        p, mesh, port = case
        q, k, v, do = p["qkvd"]
        m = jnp.asarray(p["mask"]) if masked else None
        want = _jax_grads(lambda a, b, c: jseq.ring_attention(
            a, b, c, mesh.mesh, causal=causal, mask=m), q, k, v, do=do)
        for r in port:
            _check(r[("ring", impl, causal, masked)], want)

    def test_local_slices(self, case):
        p, _, port = case
        whole = port[0][("ring", "flash", True, False)][0]
        for rank, r in enumerate(port):
            np.testing.assert_array_equal(r["ring_local"],
                                          np.split(whole, 4, axis=2)[rank])

    def test_ulysses_matches_jax(self, case):
        p, mesh, port = case
        for causal in (False, True):
            want = _jax_grads(lambda a, b, c: jseq.ulysses_attention(
                a, b, c, mesh.mesh, causal=causal), *p["heads"])
            for r in port:
                _check(r[("ulysses", causal)], want)

    def test_masked_ring_rejects_bad_mask_shape(self, case):
        for r in case[2]:
            assert r["ring_bad_mask"][0] == "ValueError"
            assert "key-padding" in r["ring_bad_mask"][1]


class TestRingFlashCore:
    """The flash core: the ring of 4 against its one-device replay, and
    the block primitives' external-lse contract against the JAX ones."""

    @pytest.mark.parametrize("causal", [False, True])
    def test_ring_equals_its_replay(self, case, causal):
        p, _, port = case
        q, k, v, do = (torch.as_tensor(t) for t in p["qkvd"])
        o, _, dq, dk, dv = pseq.replay_ring_flash(
            q, k, v, size=4, causal=causal, kmask=torch.as_tensor(p["mask"]),
            do=do)
        out, grads = port[0][("ring", "flash", causal, True)]
        np.testing.assert_array_equal(out, o.numpy())
        for a, b in zip(grads, (dq, dk, dv)):
            np.testing.assert_array_equal(a, b.numpy())

    def test_block_primitives_with_a_global_lse_match_jax(self):
        from deeplearning4j_tpu.ops.pallas.flash_attention import (
            flash_block_bwd as jax_bwd, flash_block_fwd as jax_fwd,
        )
        from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
            flash_block_bwd, flash_block_fwd,
        )

        rng = np.random.default_rng(1)
        q, k, v, do = (rng.normal(size=(1, 2, 16, 128)).astype(np.float32)
                       for _ in range(4))
        km = np.ones((1, 16), np.float32)
        km[0, 11:] = 0.0
        jo, jl = jax_fwd(*(jnp.asarray(t) for t in (q, k, v)), causal=True,
                         scale=0.1, block_q=16, block_k=16,
                         kmask=jnp.asarray(km))
        po, pl = flash_block_fwd(*(torch.as_tensor(t) for t in (q, k, v)),
                                 causal=True, scale=0.1,
                                 kmask=torch.as_tensor(km))
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), **FWD)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **FWD)
        # a "global" lse larger than the block's: the ring's later blocks
        lse = np.asarray(jl) + 0.7
        delta = (do * np.asarray(jo)).sum(-1, keepdims=True)
        jg = jax_bwd(*(jnp.asarray(t) for t in (q, k, v, do, lse, delta)),
                     causal=False, scale=0.1, block_q=16, block_k=16,
                     kmask=jnp.asarray(km))
        pg = flash_block_bwd(*(torch.as_tensor(t) for t in (
            q, k, v, do, lse, delta)), causal=False, scale=0.1,
            kmask=torch.as_tensor(km))
        for a, b in zip(pg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


class TestRingFlashShapeGuard:
    """The port's own guard: the flash kernels' block (head dim <= 128,
    f32 or bf16), not the JAX package's Mosaic rule."""

    def test_forced_flash_on_a_block_the_kernels_cannot_take(self, case):
        for r in case[2]:
            assert r["flash_bad_dim"][0] == "ValueError"
            assert "head_dim" in r["flash_bad_dim"][1]

    def test_the_mosaic_rule_is_not_carried(self):
        q = torch.zeros(1, 1, 12, 64)
        assert kernel_admits(q, q, q)
        assert not jseq._flash_core_ok(64, 12)
        assert not kernel_admits(*(torch.zeros(1, 1, 12, 256),) * 3)
        assert not kernel_admits(*(q.double(),) * 3)

    def test_merge_lse_posinf_guard(self):
        o = np.ones((1, 1, 4, 8), np.float32)
        lse = np.zeros((1, 1, 4, 1), np.float32)
        o_bad = np.full((1, 1, 4, 8), 7.0, np.float32)
        lse_bad = np.full((1, 1, 4, 1), np.inf, np.float32)
        jm, jl = jseq._merge_lse(*(jnp.asarray(t) for t in (
            o, lse, o_bad, lse_bad)))
        pm, pl = pseq.merge_lse(*(torch.as_tensor(t) for t in (
            o, lse, o_bad, lse_bad)))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(pm.numpy(), o)


class TestSequenceParallelExtended:
    @pytest.mark.parametrize("impl,causal", [("ring", True),
                                             ("ulysses", True),
                                             ("ring", False)])
    def test_encoder_block_and_gradients_match_jax(self, case, impl, causal):
        p, mesh, port = case
        params = jax.tree_util.tree_map(jnp.asarray, p["enc_params"])
        x = jnp.asarray(p["enc_x"])
        fn = lambda pp: jseq.sequence_parallel_encoder(  # noqa: E731
            pp, x, mesh.mesh, n_heads=4, causal=causal, impl=impl)
        want = np.asarray(jax.jit(fn)(params))
        g = jax.jit(jax.grad(lambda pp: (fn(pp) ** 2).sum()))(params)
        for r in port:
            y, grads = r[("encoder", impl, causal)]
            np.testing.assert_allclose(y, want, **ENC)
            for k in g:
                np.testing.assert_allclose(grads[k], np.asarray(g[k]),
                                           err_msg=k, **ENC)


class TestZigzagRing:
    def test_fwd_and_grads_match_causal_attention(self, case):
        p, _, port = case
        q, k, v, do = p["qkvd"]
        want = _jax_grads(lambda a, b, c: jax_dpa(a, b, c, causal=True),
                          q, k, v, do=do)
        for r in port:
            _check(r["zigzag"], want)

    def test_permutation_matches_jax(self):
        for T, n in ((64, 4), (32, 2), (48, 3)):
            for a, b in zip(pseq.zigzag_permutation(T, n),
                            jseq.zigzag_permutation(T, n)):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("case_name,match", [
        ("zigzag_bad_T", "divisible"), ("zigzag_bad_dim", "flash core")])
    def test_shape_guards(self, case, case_name, match):
        for r in case[2]:
            assert r[case_name][0] == "ValueError"
            assert match in r[case_name][1]


class TestZigzagAtScale:
    def test_shard_unshard_roundtrip(self, case):
        p, _, port = case
        for r in port:
            np.testing.assert_array_equal(r["zigzag_roundtrip"], p["long"][0])

    def test_pre_permuted_attention_matches(self, case):
        p, _, port = case
        q, k, v, _ = p["qkvd"]
        want = np.asarray(jax_dpa(*(jnp.asarray(t) for t in (q, k, v)),
                                  causal=True))
        for r in port:
            np.testing.assert_allclose(r["zigzag_pre"], want, **FWD)

    def test_encoder_zigzag_in_the_permuted_domain(self, case):
        """The encoder on zig-zag-permuted input gives the layer's output,
        permuted, and the layer's gradients for a permutation-invariant
        loss."""
        p, mesh, port = case
        layer = JaxEncoder(d_model=16, n_heads=4, causal=True)
        params = jax.tree_util.tree_map(jnp.asarray, p["enc_params"])
        x = jnp.asarray(p["enc_x"])
        fwd = jax.jit(lambda pp: layer.apply(pp, {}, x)[0])
        want = np.asarray(jseq.zigzag_shard(fwd(params), mesh.mesh,
                                            seq_axis=1))
        g = jax.jit(jax.grad(lambda pp: (fwd(pp) ** 2).sum()))(params)
        for r in port:
            y, grads = r[("encoder", "zigzag", True)]
            np.testing.assert_allclose(y, want, **ENC)
            for k in g:
                np.testing.assert_allclose(grads[k], np.asarray(g[k]),
                                           err_msg=k, **ENC)

    def test_zigzag_encoder_requires_causal(self, case):
        for r in case[2]:
            assert "CAUSAL" in r["encoder_zigzag_noncausal"][1]


class TestLongContext:
    def test_ring_attention_t1024(self, case):
        p, mesh, port = case
        want = np.asarray(jseq.ring_attention(
            *(jnp.asarray(t) for t in p["long"]), mesh.mesh, causal=True))
        for r in port:
            np.testing.assert_allclose(r["ring_long"], want, rtol=5e-4,
                                       atol=5e-5)


class TestUlyssesGuard:
    def test_heads_must_divide(self, case):
        for r in case[2]:
            assert "divisible" in r["ulysses_bad_heads"][1]
