"""Device mesh over the ranks of ``torch.distributed``.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The JAX class wraps
a ``jax.sharding.Mesh`` over the devices of one program. Here every rank is
a process with one card (or the CPU, under gloo), and :class:`DeviceMesh`
wraps a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks with the
same axes, ``("data", "model", "pipe", "seq")``, the same shape inference
and the same errors. Each axis has its process group (:meth:`group`), and
the rank's coordinate on it (:meth:`index`).

As in the JAX package's multi-process mode, every rank holds the whole host
batch and :meth:`shard_batch` gives this rank's slice of dim 0 over "data".
:meth:`replicate` puts a tree on the rank's device: what is replicated is
what every rank computes alike.

A mesh on the card is NCCL or it raises; ``device="cpu"`` asks for gloo.
"""

from __future__ import annotations

import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh as _TorchMesh
from torch.distributed.device_mesh import init_device_mesh

from deeplearning4j_tpu_torch.common.device import resolve_device, to_device
from deeplearning4j_tpu_torch.common.trees import tree_map
from deeplearning4j_tpu_torch.parallel.launch import BACKENDS


def _check_group(device: str) -> None:
    """The default group exists and its backend serves ``device``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: run the ranks through "
            "parallel.launch.run (or init_process_group) first")
    resolve_device(device)  # the card must be there
    backend = dist.get_backend()
    if BACKENDS[device] not in str(backend):
        raise RuntimeError(
            f"a {device} mesh needs the {BACKENDS[device]} backend; the "
            f"default group runs {backend}")


class DeviceMesh:
    """The framework's axes over the ranks of the default process group."""

    AXES = ("data", "model", "pipe", "seq")

    def __init__(self, data: int = 0, model: int = 1, pipe: int = 1,
                 seq: int = 1, devices: Optional[Sequence[int]] = None,
                 device: str = "cuda"):
        if device not in BACKENDS:
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{device!r}")
        _check_group(device)
        ranks = list(devices if devices is not None
                     else range(dist.get_world_size()))
        n = len(ranks)
        if data <= 0:
            rest = model * pipe * seq
            if n % rest:
                raise ValueError(f"{n} devices not divisible by "
                                 f"model*pipe*seq={rest}")
            data = n // rest
        shape = (data, model, pipe, seq)
        if int(np.prod(shape)) != n:
            raise ValueError(f"mesh shape {shape} != {n} devices")
        if devices is None:
            self.mesh = init_device_mesh(device, shape,
                                         mesh_dim_names=self.AXES)
        else:
            self.mesh = _TorchMesh(device, torch.tensor(ranks).reshape(shape),
                                   mesh_dim_names=self.AXES)
        self.shape = dict(zip(self.AXES, shape))
        self.device_type = device
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device == "cuda" else torch.device("cpu"))

    @property
    def n_devices(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def group(self, axis: str):
        """The process group of the ranks that differ only along ``axis``
        and include this one."""
        return self.mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.mesh.get_local_rank(axis)

    def shard_batch(self, tree):
        """This rank's slice of dim 0 of every leaf over "data", on the
        rank's device. Leaves whose dim 0 does not divide raise."""
        n, r = self.shape["data"], self.index("data")

        def take(x):
            t = torch.as_tensor(np.asarray(x) if not isinstance(
                x, torch.Tensor) else x)
            if t.shape[0] % n:
                raise ValueError(f"batch size {t.shape[0]} not divisible by "
                                 f"data-parallel degree {n}")
            b = t.shape[0] // n
            return to_device(t[r * b:(r + 1) * b], self.device)

        return tree_map(lambda x: None if x is None else take(x), tree)

    def replicate(self, tree):
        """Every tensor leaf on this rank's device."""
        return tree_map(lambda x: to_device(x, self.device)
                        if isinstance(x, torch.Tensor) else x, tree)


def multi_slice_mesh(n_slices: int, axes: Sequence[str] = ("data",),
                     devices: Optional[Sequence[int]] = None,
                     device: str = "cuda") -> _TorchMesh:
    """A torch ``DeviceMesh`` with a leading "dcn" axis grouping the ranks
    by node (the JAX function groups devices by slice): collectives over
    the trailing axis stay on a node, those over "dcn" cross nodes. When
    every rank is on one host the ranks are split evenly in order, as the
    JAX package splits virtual devices. Each "dcn" row must lie on one
    node, or it raises."""
    _check_group(device)
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    if n % n_slices:
        raise ValueError(f"{n} devices not divisible into {n_slices} slices")
    if len(axes) != 1:
        raise ValueError("multi_slice_mesh currently takes one ICI axis; "
                         "build custom shapes with a torch DeviceMesh")
    per = n // n_slices
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    if len({hosts[r] for r in ranks}) > 1:
        ranks.sort(key=lambda r: (hosts[r], r))
        for s in range(n_slices):
            row = ranks[s * per:(s + 1) * per]
            if len({hosts[r] for r in row}) != 1:
                raise ValueError(
                    f"n_slices={n_slices} does not match the "
                    f"{len(set(hosts))} nodes (a dcn row would span nodes)")
    return _TorchMesh(device, torch.tensor(ranks).reshape(n_slices, per),
                      mesh_dim_names=("dcn",) + tuple(axes))
