"""Ground-truth reference implementations (``tpu_splatting/ref_lib``
counterpart).

Deliberately independent, naive re-implementations of the differentiable
ops, to diff the production code against: built from ``lib.gaussian2d``,
``lib.transforms`` and ``lib.sh`` only, not from the production projection
or SH.  Plain torch; run them in f64 on the CPU for exact comparisons.
Not a performance path.
"""

from .projection import reference_project
from .rasterizer import rasterize_reference
from .spherical_harmonics import reference_sh

__all__ = ["reference_project", "reference_sh", "rasterize_reference"]
