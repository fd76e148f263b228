"""The constants of tpuh264/golden that the port's kernels read, copied so
that the port imports nothing of tpuh264 (the numpy oracles stay there)."""
