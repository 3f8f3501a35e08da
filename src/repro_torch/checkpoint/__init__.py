"""Checkpoints and restart supervision (counterpart of
``repro/checkpoint``)."""
