"""Serving: Ringo's interactive graph service (``graph_service``,
``scheduler``, ``policy``, ``wire``, ``server``, ``client``) and the LM
batched prefill + decode engine (``engine``).
"""
