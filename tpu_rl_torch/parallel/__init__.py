"""Attention primitives of the transformer family — the port of the
single-device parts of ``tpu_rl.parallel``."""
