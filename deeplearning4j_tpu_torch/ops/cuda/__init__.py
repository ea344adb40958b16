"""Hand-written CUDA kernels for Hopper (counterpart of ``ops/pallas``).

Importing registers each kernel with the op registry; nothing is built
until a kernel is first launched.
"""

from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
    FLASH_DKV, FLASH_DQ, FLASH_FWD,
)
from deeplearning4j_tpu_torch.ops.cuda.fused_gru import FUSED_GRU, FUSED_GRU_BWD
from deeplearning4j_tpu_torch.ops.cuda.fused_lstm import FUSED_LSTM, FUSED_LSTM_BWD
from deeplearning4j_tpu_torch.ops.cuda.lrn import LRN_BWD, LRN_FWD

#: every hand-written kernel, for launch counting and the chip smoke run
KERNELS = (FUSED_LSTM, FUSED_LSTM_BWD, FUSED_GRU, FUSED_GRU_BWD, FLASH_FWD,
           FLASH_DQ, FLASH_DKV, LRN_FWD, LRN_BWD)

__all__ = ["FLASH_DKV", "FLASH_DQ", "FLASH_FWD", "FUSED_GRU", "FUSED_GRU_BWD",
           "FUSED_LSTM", "FUSED_LSTM_BWD", "KERNELS", "LRN_BWD", "LRN_FWD"]
