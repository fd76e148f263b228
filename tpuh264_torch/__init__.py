"""tpuh264_torch: the PyTorch / CUDA (NVIDIA Hopper) port of tpuh264.

The JAX package `tpuh264` is the reference; this package reproduces its
IPPP GOP device pipeline (`engine.devpipe.GOPDevicePipeline`) bit for
bit.  Plain tensor code is PyTorch; the three kernels that the JAX
package writes in Pallas are CUDA C++ for sm_90a under `csrc/`, each
with a plain PyTorch version beside its wrapper (`kernels/me_cuda.py`,
`kernels/cavlc_cuda.py`).

The port imports nothing of `tpuh264` and nothing of `jax`.  What it
needs of the JAX package's JAX-free layers it holds as copies, each
naming its original: `core/` (bitstream, NAL, SPS/PPS, slice headers),
`entropy/cavlc_tables.py`, the constants of `golden/` that the kernels
read, and the host CAVLC engine (`native/cavlc.cpp`, bound by
`entropy/native.py` and built with g++ into `build/` at first use).
"""
