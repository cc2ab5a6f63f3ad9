"""Device milliseconds an update of the operations whose launch the host issued
inside the train step's ``train_step.backward`` span: the gradients
(``torch.autograd.grad``). From the spans pass (``portbench.phases``); None
where the program has no spans or the run has no device trace."""

from portbench.phases import device_ms


def read(run):
    return device_ms(run, "backward")
