"""Training: AdamW, int8 gradient compression and the train loop (`fit`)."""
