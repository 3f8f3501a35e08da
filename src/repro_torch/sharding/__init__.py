"""Sharding rules over ``DeviceMesh`` (counterpart of ``repro/sharding``)."""
