"""Benchmark harness of the port: the configuration matrix (`harness`),
rate-distortion against libx264 (`quality`) and SVG charts (`charts`, a
copy).  Port of tpuh264/bench/."""

from .harness import run_matrix, run_single

__all__ = ["run_matrix", "run_single"]
