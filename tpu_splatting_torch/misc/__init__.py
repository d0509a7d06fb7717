"""The port's ``tpu_splatting/misc`` counterpart: the 2D gaussian path
``renderer2d``, which the fit-image trainer
(``tpu_splatting_torch.examples.fit_image_gaussians``) and the
``vis_split`` / ``test_backward`` examples render and split through;
``morton`` (Morton codes and spatial ordering) and ``indexing`` (a
differentiable gather and a segmented sort)."""
