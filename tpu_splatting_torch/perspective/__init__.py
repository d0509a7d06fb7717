from .params import CameraParams
from .projection import (inverse_ndc_depth, ndc_depth, project_gaussians,
                         project_to_image, unproject_points)

__all__ = ["CameraParams", "project_to_image", "project_gaussians",
           "ndc_depth", "inverse_ndc_depth", "unproject_points"]
