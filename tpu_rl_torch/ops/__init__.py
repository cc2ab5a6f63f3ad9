"""Tensor ops of the port: distribution math and the hand-written kernels' wrappers."""
