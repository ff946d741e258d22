"""Process-group helpers of the graph engine's multi-rank paths.

Counterpart of ``repro/launch/mesh.py``'s graph mesh: a shard is one rank of
a ``torch.distributed`` world, not one device of a JAX mesh.  The LM mesh
helpers come with the training slice (ROADMAP Queue 1 item 15).
"""
