"""gpgpuraytrace_tpu_torch: the procedural-terrain ray-marcher in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``gpgpuraytrace_tpu``, which stays the reference;
the module tree and function names mirror it. This package imports torch and
numpy only, never jax or the JAX package.

Layout:
  models/    Scene (nn.Modules) and RenderConfig
  ops/       plain PyTorch path: noise, camera, field, march, shade, render;
             the fit loop and the finite-difference gradient check
  kernels/   the CUDA trace kernels (forward and backward), their build,
             wrappers and plain versions
  utils/     scalar packing, scene <-> numpy conversion, image writers
"""

from gpgpuraytrace_tpu_torch.models.scene import (  # noqa: F401
    RenderConfig,
    Scene,
    default_scene,
)
from gpgpuraytrace_tpu_torch.ops.render import render  # noqa: F401
