"""Device kernels (JAX/XLA): xcorr, DS, rolling stats, triggers."""
from detex_tpu.ops import ds, rolling, stalta, subsample, svd, triggers, xcorr

__all__ = ["ds", "rolling", "stalta", "subsample", "svd", "triggers",
           "xcorr"]
