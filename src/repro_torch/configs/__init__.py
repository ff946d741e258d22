"""Model configurations (see ``repro.configs``): the dense and MoE families so far."""
