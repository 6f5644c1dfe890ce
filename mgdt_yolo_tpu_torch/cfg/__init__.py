"""Run configuration of the port."""
