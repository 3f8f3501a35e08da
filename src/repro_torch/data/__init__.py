"""Input pipelines (counterpart of ``repro/data``)."""
