"""Optimizers of the port (``tpu_splatting/optim`` counterpart): the
fractional optimizers (``fractional.py``) and ``ParameterClass``
(``parameter_class.py``: parameters with row-synchronised optimizer
state, for split/prune training)."""

from .fractional import (FractionalAdam, FractionalLaProp, FractionalOpt,
                         FractionalState, GroupConfig, SparseAdam,
                         SparseLaProp, VisibilityAwareAdam,
                         VisibilityAwareLaProp, VisibilityOptimizer)
from .parameter_class import ParameterClass

__all__ = [
    "GroupConfig", "FractionalOpt", "FractionalState", "FractionalAdam",
    "FractionalLaProp", "SparseAdam", "SparseLaProp", "VisibilityOptimizer",
    "VisibilityAwareAdam", "VisibilityAwareLaProp", "ParameterClass",
]
