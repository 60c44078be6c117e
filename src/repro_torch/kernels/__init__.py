"""Hand-written CUDA kernels of the port, their wrappers and plain twins.

Importing this package never needs ``nvcc`` or a card: the shared library
is built and loaded on the first launch (``build.library()``).
"""
