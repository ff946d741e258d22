"""Ringo's graph-analytics engine in PyTorch, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``core/table.py``, ``core/relational.py``, ``core/convert.py``,
``core/provenance.py``, ``core/graph.py``, ``core/plan.py``,
``core/engine.py``, ``core/algorithms.py``, ``kernels/*``, ``obs/*``, the
interactive service ``serve/{graph_service,scheduler,policy,wire,server,
client}.py``, and for the dense language models ``configs/*``,
``models/*`` and ``serve/engine.py``) so each module's counterpart is found
by its path; ``examples/`` runs the reference's quickstart and its §4.1
StackOverflow session, in process and over a socket.  It imports ``torch`` and never ``jax``,
and nothing of ``repro``.  The four Pallas TPU kernels (the three on the
PageRank / HITS / triangle path and the attention forward of the dense
models) are hand-written CUDA kernels here (``kernels/csrc/*.cu``), built
with ``nvcc`` at first use.

Entry points run on the card unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve`).
"""
