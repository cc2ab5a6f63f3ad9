"""Build and binding of the port's CUDA sources (csrc/)."""
