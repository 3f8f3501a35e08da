"""Serving: the slot engine and its samplers (counterparts of
``repro/serve``)."""
