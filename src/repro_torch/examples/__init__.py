"""Runnable examples of the port, each `python -m repro_torch.examples.<name>`
(on the card unless given `--device cpu`)."""
