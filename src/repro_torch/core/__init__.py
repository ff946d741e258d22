"""Graph storage, traversal plan, engine and algorithms (see ``repro.core``)."""
