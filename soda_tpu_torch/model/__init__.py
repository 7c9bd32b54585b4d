"""What the built kernels are: compiled statistics of the fused kernel."""
