"""Milliseconds an update that the device sat idle in gaps that began while the
host was inside the train step's ``train_step.forward`` span: the model's
forward and the loss (``loss_fn``: returns, V-trace, the surrogate, the in-
loss diag rows). From the spans pass (``portbench.phases``); None where the
program has no spans or the run has no device trace."""

from portbench.phases import idle_ms


def read(run):
    return idle_ms(run, "forward")
