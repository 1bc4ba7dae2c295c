"""Model FLOPs of a call (counted on the reference at the cell's shapes) over the
untraced window's time a call, against the H100's fp32 peak of 67 TFLOP/s."""
from benchmark.readers import mfu_pct as read  # noqa: F401
