"""Fault tolerance of the port's training loop (`repro.runtime`)."""
