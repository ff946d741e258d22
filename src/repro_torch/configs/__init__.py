"""Model configurations (see ``repro.configs``): every LM family of the reference."""
