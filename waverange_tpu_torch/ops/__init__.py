"""Device-side compute ops of the codec on torch tensors: plain torch
versions for CPU tensors, hand-written CUDA kernels for CUDA tensors."""

from .wavelet import cdf97_3d, cdf97_forward, cdf97_inverse  # noqa: F401
from .quant import (accumulate_layers, decode_step,  # noqa: F401
                    encode_step, quantize_layers)
