"""Runtime helpers (counterpart of ``repro.runtime``)."""
