"""Training-side state of the port: so far the checkpoint format that
inference restores from (train/checkpoint.py)."""
