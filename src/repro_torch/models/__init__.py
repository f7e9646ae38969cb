"""The decoder-only LM of the port (dense attention blocks): layers, the
LM module, the model facade and the analytic FLOP model."""
