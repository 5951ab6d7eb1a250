"""Stereo configurations (counterpart of ``repro.configs.elas_stereo``)."""
