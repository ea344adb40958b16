"""Autodiff utilities: gradient checking and the SameDiff graph API.

Counterpart of ``deeplearning4j_tpu/autodiff/__init__.py`` (org.nd4j.autodiff:
SameDiff define-then-run graphs, validation.OpValidation, GradCheckUtil),
with the same exports. SameDiff lives in ``autodiff.samediff``.
"""

from deeplearning4j_tpu_torch.autodiff.gradcheck import (
    grad_check, grad_check_graph, grad_check_model,
)

__all__ = ["grad_check", "grad_check_graph", "grad_check_model"]
