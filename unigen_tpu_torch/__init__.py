"""unigen_tpu_torch: the PyTorch/CUDA port of unigen_tpu for NVIDIA Hopper.

Parameters are nested dicts of tensors in the JAX package's layout, the math
is plain functions on tensors, and the TPU's Pallas kernels are hand-written
CUDA kernels under ``ops/cuda`` (sources in ``csrc/``). The serving entry is
``models.unigen_flux.UniGenFlux`` wrapped in ``serving.MicroBatchServer``;
``pipelines.loading.load_flux_pipeline`` and ``load_sd3_pipeline`` build the
pipelines from diffusers checkpoint directories; ``cli.train`` is the
training entry point (``python -m unigen_tpu_torch.cli.train``).
The package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
