# Copy of tpuh264/golden/__init__.py, so that the port imports nothing of tpuh264.
"""numpy reference model of the codec -- the test oracle.

Everything here is scalar-clarity-first numpy; the JAX/Pallas kernels in
tpuh264.kernels must match these functions bit-exactly (tests enforce it),
and libavcodec must reconstruct our encoded streams identically to our
decoder (tpuh264.conformance).
"""
