"""Launchers and the multi-rank layout.

``mesh.py``: the graph engine's shard groups and the LM's (data, model)
grid, ranks of a ``torch.distributed`` world where the reference has
devices of a JAX mesh; ``sharding.py`` and ``specs.py``: the logical-axis
rules, parameter specs and per-rank input shapes; ``train.py`` and
``elastic.py``: training.
"""
