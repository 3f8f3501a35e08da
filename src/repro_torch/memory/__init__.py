"""In-package memory: DRAM-stack timing and the closed-loop table encoding.

Copies of ``repro.memory.model`` and ``repro.memory.table`` (numpy); the
closed-loop engine path is not ported yet.
"""
