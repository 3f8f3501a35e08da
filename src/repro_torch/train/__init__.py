"""Training: AdamW, schedules and the step factory (counterpart of
``repro/train``)."""
