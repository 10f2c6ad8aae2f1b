"""waverange_tpu_torch — the WaveRange field codec's device step in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It mirrors `waverange_tpu` module by module: `ops.wavelet` (CDF 9/7
lifting), `ops.quant` (byte-layer quantizer and decode accumulate) and
`core.codec` (field encode/decode). The host entropy coders are shared
with `waverange_tpu.native`, and streams are `waverange_tpu` streams.

Importing the package builds nothing: the CUDA kernels are compiled by
`ops._build` at their first launch.
"""

__version__ = "0.1.0"
