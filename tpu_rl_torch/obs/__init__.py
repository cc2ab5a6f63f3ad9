"""Learning-dynamics diagnostics of the train step."""
