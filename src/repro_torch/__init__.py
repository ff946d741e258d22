"""Ringo's graph-analytics engine in PyTorch, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``core/graph.py``, ``core/plan.py``, ``core/engine.py``,
``core/algorithms.py``, ``kernels/*``) so each module's counterpart is found
by its path.  It imports ``torch`` and never ``jax``, and nothing of
``repro``.  The three Pallas TPU kernels on the PageRank / HITS / triangle
path are hand-written CUDA kernels here (``kernels/csrc/*.cu``), built with
``nvcc`` at first use.

Entry points run on the card unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve`).
"""
