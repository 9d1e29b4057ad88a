"""The reference's examples on the port: ``python -m
repro_torch.examples.<name> [--device cpu]`` (the card by default)."""
