"""Runtime of the port: the serving service and the colocated training loop."""
