from hlod_gaussians_torch.preprocess import depth_scale, reorient  # noqa: F401
