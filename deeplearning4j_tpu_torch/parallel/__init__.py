"""Parallelism (counterpart of ``deeplearning4j_tpu/parallel``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``, where
XLA inserts the collectives. The port takes that package's multi-process
form as its only form:

- one process a rank and one card a process (local rank ->
  ``cuda:<local rank>``), joined by ``torch.distributed``: NCCL on the card,
  gloo when the caller asks for the CPU, never a fallback from one to the
  other (:mod:`.launch` spawns the ranks, as ``jax.distributed`` joins the
  JAX package's hosts);
- :class:`DeviceMesh` over ``torch.distributed.device_mesh`` with the JAX
  axis names ("data", "model", "pipe", "seq");
- every rank calls the same entry point (``wrapper.fit_batch(ds)``) with the
  same global host batch and takes its slice by rank;
- the collectives that sit inside a forward pass are differentiable
  (:mod:`.collectives`), and a data-parallel step reaches the other
  replicas through the train step's hook (``nn/replicas.py``).

Ported here: the mesh, data parallelism (:class:`ParallelWrapper`), tensor
and expert parallelism, ring / zig-zag / Ulysses sequence parallelism on
the flash kernels' block primitives, threshold-encoded gradient sharing,
parameter averaging (local SGD), and :mod:`.inference`, the request
batching in front of a model's ``output()`` (``mesh=None`` only). The
pipeline (GPipe, HeteroPipe), the Spark shims and the fault-tolerant
trainer are not ported yet.
"""

from deeplearning4j_tpu_torch.parallel.compression import (
    EncodedGradientTrainer, message_density, threshold_encode,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.expert import (
    init_moe_params, moe_param_specs, place_moe_params, switch_moe,
)
from deeplearning4j_tpu_torch.parallel.inference import (
    DeadlineExceeded, ParallelInference, resolve,
)
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh, multi_slice_mesh
from deeplearning4j_tpu_torch.parallel.param_averaging import (
    ParameterAveragingTrainer,
)
from deeplearning4j_tpu_torch.parallel.sequence import (
    ring_attention, ring_attention_zigzag, sequence_parallel_encoder,
    ulysses_attention, zigzag_shard, zigzag_unshard,
)
from deeplearning4j_tpu_torch.parallel.tensor_parallel import TensorParallel

__all__ = ["DeviceMesh", "multi_slice_mesh", "ParameterAveragingTrainer",
           "ParallelWrapper", "ParallelInference", "DeadlineExceeded",
           "resolve", "TensorParallel", "init_moe_params",
           "moe_param_specs", "place_moe_params", "switch_moe",
           "ring_attention", "ring_attention_zigzag", "ulysses_attention",
           "sequence_parallel_encoder", "zigzag_shard", "zigzag_unshard",
           "EncodedGradientTrainer", "threshold_encode", "message_density"]
