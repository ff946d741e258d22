"""Model configurations (see ``repro.configs``): the dense family so far."""
