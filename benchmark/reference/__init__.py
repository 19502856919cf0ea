"""The benchmark's plain reference of the MonoSlam frame step: plain PyTorch,
importing nothing of the port and nothing of JAX."""
