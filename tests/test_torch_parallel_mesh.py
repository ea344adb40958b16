"""The port's mesh, launcher and collectives (``parallel/mesh.py``,
``parallel/launch.py``, ``parallel/collectives.py``) in a gloo world of 4
ranks, against the JAX package's mesh rules; the op registry's choice cache
key by device.

One world runs every mesh case (``torch_parallel_ranks.mesh_world``); the
launcher's failure paths spawn their own small worlds with short limits.
The JAX side of the mesh rules runs on the conftest's 8 virtual devices.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import DeviceMesh as JaxMesh
from deeplearning4j_tpu.parallel import multi_slice_mesh as jax_multi_slice
from deeplearning4j_tpu_torch.ops.registry import _signature
from deeplearning4j_tpu_torch.parallel import launch

import torch_parallel_ranks as ranks

WORLD = 4


@pytest.fixture(scope="module")
def world():
    return launch.run(ranks.mesh_world, WORLD, device="cpu", threads=1,
                      timeout=240)


class TestDeviceMesh:
    def test_default_puts_every_rank_on_data(self, world):
        # the JAX rule on its 8 devices: data = n / (model * pipe * seq)
        assert JaxMesh().shape["data"] == 8
        for r in world:
            assert r["default"] == {"data": WORLD, "model": 1, "pipe": 1,
                                    "seq": 1}

    def test_axes(self, world):
        assert JaxMesh(data=2, model=4).shape == {"data": 2, "model": 4,
                                                  "pipe": 1, "seq": 1}
        for r in world:
            assert r["data2_model2"] == {"data": 2, "model": 2, "pipe": 1,
                                         "seq": 1}
            assert r["model2"]["data"] == WORLD // 2

    @pytest.mark.parametrize("case,match", [("bad_shape", "mesh shape"),
                                            ("bad_rest", "not divisible")])
    def test_same_errors_as_jax(self, world, case, match):
        with pytest.raises(ValueError, match=match):
            JaxMesh(**({"data": 3} if case == "bad_shape" else {"model": 3}))
        for r in world:
            assert r[case][0] == "ValueError" and match in r[case][1]

    def test_coordinates_and_batch_slices(self, world):
        x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        for rank, r in enumerate(world):
            d, s, n = r["index"]
            assert (d, s, n) == (rank // 2, rank % 2, WORLD)
            got_x, got_col = r["shard"]
            np.testing.assert_array_equal(got_x, x[4 * d:4 * d + 4])
            np.testing.assert_array_equal(got_col, x[4 * d:4 * d + 4, 0])
            assert "not divisible" in r["shard_bad"][1]

    def test_a_cuda_mesh_without_a_card_raises(self, world):
        """No fallback to gloo: a mesh on the card needs the card."""
        for r in world:
            assert r["cuda"][0] == "RuntimeError"
            assert "is_available" in r["cuda"][1]


class TestMultiSlice:
    def test_multi_slice_mesh_shape(self, world):
        jm = jax_multi_slice(2)
        assert jm.axis_names == ("dcn", "data")
        for rank, r in enumerate(world):
            names, shape, dcn, data = r["slices"]
            assert names == tuple(jm.axis_names)
            assert shape == (2, WORLD // 2)
            assert (dcn, data) == (rank // 2, rank % 2)
            assert r["slices_bad"][0] == "ValueError"


class TestCollectives:
    """Values and gradients of the differentiable collectives over the
    "data" axis of a (data 2, seq 2) mesh: rank r's partner is r ^ 2."""

    def test_psum_sums_values_and_gradients(self, world):
        for rank, r in enumerate(world):
            other = rank ^ 2
            y, g = r["psum"]
            np.testing.assert_allclose(y, np.arange(4.0) * (rank + other + 2))
            np.testing.assert_allclose(g, np.full(4, 2.0 * (rank + 1)))

    def test_all_gather_gives_back_this_ranks_slice(self, world):
        for rank, r in enumerate(world):
            y, g = r["all_gather"]
            lo, hi = sorted((rank, rank ^ 2))
            np.testing.assert_allclose(y, np.concatenate(
                [np.arange(4.0) * (lo + 1), np.arange(4.0) * (hi + 1)]))
            me = 0 if rank < 2 else 1
            np.testing.assert_allclose(
                g, np.arange(8.0)[4 * me:4 * me + 4] * (rank + 1))

    def test_shard_gathers_the_slices_gradients(self, world):
        for rank, r in enumerate(world):
            y, g = r["shard_grad"]
            me = 0 if rank < 2 else 1
            np.testing.assert_allclose(y, np.arange(4.0)[2 * me:2 * me + 2])
            lo, hi = sorted((rank, rank ^ 2))
            np.testing.assert_allclose(g, [lo + 1] * 2 + [hi + 1] * 2)

    def test_all_to_all_and_its_transpose(self, world):
        for rank, r in enumerate(world):
            y, g = r["all_to_all"]
            me = 0 if rank < 2 else 1
            lo, hi = sorted((rank, rank ^ 2))
            mine = np.arange(4.0)[2 * me:2 * me + 2]
            want = np.concatenate([mine + 10 * lo, mine + 10 * hi])
            np.testing.assert_allclose(y, want)
            # my chunk j went to rank j, whose weights were arange(4)
            np.testing.assert_allclose(g, [2 * me, 2 * me + 1] * 2)

    def test_rotate_and_its_transpose(self, world):
        for rank, r in enumerate(world):
            y, g = r["rotate"]
            np.testing.assert_allclose(y, [float(rank ^ 2)])
            # the gradient comes back from the rank that received x
            np.testing.assert_allclose(g, [float((rank ^ 2) + 1)])


class TestLauncher:
    def test_a_rank_that_raises_surfaces_in_the_caller(self):
        with pytest.raises(ValueError, match="rank one failed") as info:
            launch.run(ranks.raising_rank, 2, device="cpu", threads=1,
                       timeout=120)
        assert any("rank 1 of 2" in n for n in info.value.__notes__)

    def test_a_rank_that_hangs_is_killed_at_the_limit(self):
        with pytest.raises(TimeoutError, match=r"ranks \[0"):
            launch.run(ranks.hanging_rank, 2, device="cpu", threads=1,
                       timeout=6)

    @pytest.mark.parametrize("world_size", [1, 2])
    def test_a_cuda_world_without_cards_raises(self, world_size):
        if torch.cuda.device_count() >= world_size:
            pytest.skip("this machine has the cards")
        with pytest.raises(RuntimeError, match="card"):
            launch.run(ranks.hanging_rank, world_size, device="cuda")

    def test_unknown_device_raises(self):
        with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
            launch.run(ranks.hanging_rank, 1, device="tpu")


def test_choice_cache_keys_on_the_device_index():
    """A plan chosen for one card is never reused for another: the
    signature holds (type, index)."""
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    assert _signature(a) != _signature(b)
    assert _signature(a) == _signature(torch.device("cuda:0"))
    assert _signature(torch.zeros(2))[1] == ("cpu", None)
    assert _signature((a,)) != _signature((b,))
