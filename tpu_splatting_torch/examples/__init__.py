"""The port's examples (``examples/`` counterparts that live inside the
package): ``fit_image_gaussians``, the end-to-end 2D training example."""
