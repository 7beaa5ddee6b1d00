"""The optimizer: AdamW (``adamw``: the conv trainer's update, the LM
state's in-place one and its moment specs) and its learning rate
schedules (``schedule``)."""
