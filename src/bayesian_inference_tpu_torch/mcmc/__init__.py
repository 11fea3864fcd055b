"""Emulated likelihood, stretch-move sampler, runner and chain diagnostics."""
