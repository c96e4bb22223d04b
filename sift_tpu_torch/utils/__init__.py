"""Small helpers of the PyTorch port: device constants, metrics logging
and profiling (`utils/metrics.py`), NaN and determinism checks
(`utils/debug.py`)."""
