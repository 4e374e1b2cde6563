"""The benchmark of maria_torch on one NVIDIA H100: ``python3 -m portbench.run``."""
