"""The transformer: layers, attention, the MoE FFN and the model (see ``repro.models``)."""
