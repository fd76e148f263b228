# Copy of tpuh264/conformance/__init__.py, so that the port imports nothing of tpuh264.
from .ffdec import decode_with_libav, libav_available

__all__ = ["decode_with_libav", "libav_available"]
