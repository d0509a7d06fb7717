"""The port's 2D gaussian path (``tpu_splatting/misc`` counterpart):
``renderer2d``, which the fit-image trainer
(``tpu_splatting_torch.examples.fit_image_gaussians``) renders and splits
through."""
