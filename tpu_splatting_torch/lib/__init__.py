from . import gaussian2d, sh, transforms

__all__ = ["gaussian2d", "sh", "transforms"]
