"""See the package docstring of surikatoko_tpu_torch."""
