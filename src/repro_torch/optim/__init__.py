"""The port's optimizer (`repro.optim`)."""
