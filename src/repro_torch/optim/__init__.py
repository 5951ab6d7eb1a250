"""Optimiser, schedule and gradient compression (counterpart of ``repro.optim``)."""
