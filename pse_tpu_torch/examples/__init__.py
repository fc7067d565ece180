"""Twins of the repository's ``examples/`` on the port; run one with
``python -m pse_tpu_torch.examples.<name> [--device cpu]``."""
