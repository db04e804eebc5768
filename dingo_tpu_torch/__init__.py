"""PyTorch + CUDA port of dingo-tpu's Index role (IVF_FLAT + FLAT serving).

The JAX package ``dingo_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX. Device state lives in torch tensors and
the two hot scans run hand-written Hopper kernels (``ops/kernel_topk.py``,
``ops/kernel_ivf.py``, sources under ``csrc/``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device they raise instead of falling back.
"""
