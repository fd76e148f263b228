"""Benchmark package of the port: the configuration matrix (`harness`),
rate-distortion against libx264 (`quality`), SVG charts (`charts`, a
copy), and the measurement entry points, each `python -m
tpuh264_torch.bench.<name>`: `headline` (bench.py's gated headline),
`config3`, `ingest`, `multihost`, `rd` and `live` (the analogs of
tools/bench_config3.py, bench_ingest.py, bench_multihost.py, bench_rd.py
and live.py).  Port of tpuh264/bench/."""

from .harness import run_matrix, run_single

__all__ = ["run_matrix", "run_single"]
