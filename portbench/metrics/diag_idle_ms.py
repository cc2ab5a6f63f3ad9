"""Milliseconds an update that the device sat idle in gaps that began while the
host was inside the train step's ``train_step.diag`` span: the diag norms
after the epochs (``module_grad_norms``, ``tree_delta_norm``,
``tree_norm``). From the spans pass (``portbench.phases``); None where the
program has no spans or the run has no device trace."""

from portbench.phases import idle_ms


def read(run):
    return idle_ms(run, "diag")
