"""Optimizers of the port (``tpu_splatting/optim`` counterpart).

``parameter_class.py`` (row surgery for densification) is ROADMAP P11.
"""

from .fractional import (FractionalAdam, FractionalLaProp, FractionalOpt,
                         FractionalState, GroupConfig, SparseAdam,
                         SparseLaProp, VisibilityAwareAdam,
                         VisibilityAwareLaProp, VisibilityOptimizer)

__all__ = [
    "GroupConfig", "FractionalOpt", "FractionalState", "FractionalAdam",
    "FractionalLaProp", "SparseAdam", "SparseLaProp", "VisibilityOptimizer",
    "VisibilityAwareAdam", "VisibilityAwareLaProp",
]
