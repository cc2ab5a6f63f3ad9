"""Device milliseconds an update of the operations whose launch the host issued
inside the train step's ``train_step.diag`` span: the diag norms after the
epochs (``module_grad_norms``, ``tree_delta_norm``, ``tree_norm``). From the
spans pass (``portbench.phases``); None where the program has no spans or
the run has no device trace."""

from portbench.phases import device_ms


def read(run):
    return device_ms(run, "diag")
