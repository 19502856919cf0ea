"""The port's counterparts of the JAX package's demos (``demos/`` at the
repo root), as importable runners that return their metrics. Each runs on
the card unless the caller asks for the CPU, and is runnable with
``python -m surikatoko_tpu_torch.demos.<name>``."""
