"""The optimizer of the conv trainer: AdamW (``adamw``) and its learning
rate schedules (``schedule``)."""
