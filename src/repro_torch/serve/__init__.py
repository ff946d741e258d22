"""LM serving: the batched prefill + decode engine (see ``repro.serve.engine``)."""
