"""Model side of the port: layers, attention, the dense transformer and the
``Model`` wrapper (counterparts of ``repro/models``)."""
