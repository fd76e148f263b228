"""tpuh264_torch: the PyTorch / CUDA (NVIDIA Hopper) port of tpuh264.

The JAX package `tpuh264` is the reference; this package has a
counterpart for each of its modules, bit for bit on the same inputs:
the kernels (`kernels/`: the I scan with Intra_4x4, the P encode and
decode with 1..4 references, intra-in-P, the 8x8 transform and the DPB
halo, the deblock, the wavefront, colour, on-device CAVLC), the engine
(`engine/`: the GOP and I-only device pipelines, the sessions and
decoder pool with CAVLC and CABAC, the session pipeline and the live
App), entropy (`entropy/`: slice headers and `assemble_*` for the
device CAVLC, the host CAVLC engine, the CABAC coders), the distribution
layer (`dist/`: the (streams, rows) mesh over torch.distributed and the
multi-host worker), the bench (`bench/`: harness, quality, charts) and
the conformance gate.  Plain tensor code is PyTorch; the three kernels
that the JAX package writes in Pallas are CUDA C++ for sm_90a under
`csrc/`, each with a plain PyTorch version beside its wrapper
(`kernels/me_cuda.py`, `kernels/cavlc_cuda.py`).

The port imports nothing of `tpuh264` and nothing of `jax`.  What it
needs of the JAX package's JAX-free layers it holds as copies, each
naming its original: `core/`, the numpy `golden/` codec, the entropy
tables and packers, `conformance/{ffdec,ffenc}.py`,
`engine/libav_backend.py`, `bench/charts.py`, and the host CAVLC engine
(`native/cavlc.cpp`, bound by `entropy/native.py` and built with g++
into `build/` at first use).  Entry points run on the card unless the
caller passes `device="cpu"`.
"""
