# Copy of tpuh264/core/__init__.py, so that the port imports nothing of tpuh264.
from .bitstream import BitWriter, BitReader
from . import nal
from .params import SPS, PPS
from .sliceheader import SliceHeader

__all__ = ["BitWriter", "BitReader", "nal", "SPS", "PPS", "SliceHeader"]
