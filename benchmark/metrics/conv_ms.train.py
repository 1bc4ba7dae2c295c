"""Device ms a call in the convolution class of KERNEL_CLASSES (the traced slice)."""
from benchmark.readers import class_ms


def read(rec):
    return class_ms(rec, "convolution")
