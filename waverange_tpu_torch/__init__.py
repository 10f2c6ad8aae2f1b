"""waverange_tpu_torch — the WaveRange field codec's device step in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It mirrors `waverange_tpu` module by module: `ops.wavelet` (CDF 9/7
lifting), `ops.quant` (byte-layer quantizer and decode accumulate) and
`core.codec` (field encode/decode), and `ops.rans` (the turbo rANS
entropy stage on the device). `native` is the port's own copy of the C++
host coder library; streams are WaveRange streams, byte-identical to the
reference package's. The port imports neither JAX nor `waverange_tpu`.

Importing the package builds nothing: the CUDA kernels are compiled by
`ops._build` at their first launch, the host library by `native.build`
at its first call.
"""

__version__ = "0.1.0"
