"""The least time of a call's raster work (its projected faces and image size)
over the device time of the port's raster kernels a call (the traced slice)."""
from benchmark.readers import raster_roofline_pct as read  # noqa: F401
