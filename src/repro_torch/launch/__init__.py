"""Command-line entry points (counterparts of ``repro/launch``)."""
