"""The calling thread's CPU ms a call over the untraced window."""
from benchmark.readers import host_cpu_ms as read  # noqa: F401
