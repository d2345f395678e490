"""PyTorch and CUDA port of human_body_reconstruction_tpu, for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here mirrors
the JAX module of the same path, and the tests hold each against it.  This
package imports torch and never jax.  Plain tensor code is PyTorch; the
TPU's Pallas kernels on the serving path are CUDA kernels written for
Hopper (csrc/), each with a plain PyTorch version of the same function
beside it.  A kernel wrapper runs the plain version for tensors on the CPU
and launches its kernel (or raises) for tensors on a CUDA device.
"""

__version__ = "0.1.0"

from human_body_reconstruction_tpu_torch.utils import config as config  # noqa: F401
