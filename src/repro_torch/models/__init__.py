"""Model side of the port: layers, attention, the SSM and MoE layers, the
decoder-only transformer (dense, moe, ssm and hybrid families) and the
``Model`` wrapper (counterparts of ``repro/models``)."""
