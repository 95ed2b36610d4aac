"""The benchmark of molar_tpu_torch (see portbench/README.md)."""
