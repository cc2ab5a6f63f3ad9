"""Tensor ops of the port: distribution math, returns, losses and the hand-written kernels' wrappers."""
