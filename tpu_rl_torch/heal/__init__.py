"""Numerical-fault guards of the train step."""
