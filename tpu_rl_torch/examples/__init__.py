"""Runnable examples of the port (``python -m tpu_rl_torch.examples.<name>``)."""
