"""iELAS frame path in PyTorch (counterpart of ``repro.core``)."""
