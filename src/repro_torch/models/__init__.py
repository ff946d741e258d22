"""The dense transformer: layers, attention and model (see ``repro.models``)."""
