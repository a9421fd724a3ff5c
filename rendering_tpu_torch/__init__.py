"""rendering_tpu_torch — the PyTorch + CUDA port of `rendering_tpu`.

The JAX package beside it is the reference each module here is held
against; this package imports neither JAX nor anything of it. Module
names follow the JAX package so each counterpart is easy to find:

  flagship            benchmark scene builder (host numpy)
  models              settings, scene definitions, scene tensors
  accel.bvh           Morton triangle order
  ops                 (3, R) row-tensor math; cuda_intersect holds the
                      hand-written CUDA closest-hit / any-hit kernels
  render              ray generation, integrator, render pipeline
  convert             JAX scene leaves (as numpy) -> port SceneData

Entry points run on the CUDA device unless the caller passes
device="cpu"; with no GPU and no explicit device they raise.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
