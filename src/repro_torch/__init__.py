"""PyTorch/CUDA port of the iELAS stereo pipeline (the JAX package ``repro``
is the reference it is held against).

The layout mirrors ``repro`` file for file.  Plain tensor code is PyTorch;
the two kernels on the frame path (support search, streaming dense scan)
are hand-written CUDA C++ under ``kernels/csrc``, built at first use.  The
package imports ``torch`` and numpy only -- never ``jax``, never ``repro``.
"""
