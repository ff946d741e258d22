"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper (``bsr_spmv``, ``segment_sum_chunked``, ``bsr_tricount``)
launches its kernel on a CUDA tensor, or raises; on a CPU tensor it runs the
plain version beside it.  ``wrapper.launches`` counts kernel launches.
"""
