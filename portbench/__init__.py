"""The benchmark of pse_tpu_torch: harness, reference, yardstick and data.

Run as ``python3 -m portbench.run`` from the root of a checkout (see run.py).
"""
