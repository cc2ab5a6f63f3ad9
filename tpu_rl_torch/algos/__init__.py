"""Algorithms: train states, optimizers and train steps."""
