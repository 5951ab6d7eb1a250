"""PyTorch/CUDA port of the iELAS stereo pipeline (the JAX package ``repro``
is the reference it is held against).

The layout mirrors ``repro`` file for file.  Plain tensor code is PyTorch;
the kernels on the frame path (Sobel, support search, the streaming and the
candidate-window dense match, median) are hand-written CUDA C++ under
``kernels/csrc``, built at first use.  The package imports ``torch`` and
numpy only -- never ``jax``, never ``repro``.
"""
