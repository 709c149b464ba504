"""End-to-end pipeline stages (port of hlod_gaussians_tpu/pipeline)."""
