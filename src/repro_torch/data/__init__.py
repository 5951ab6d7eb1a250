"""Synthetic stereo data (counterpart of ``repro.data.stereo``)."""
