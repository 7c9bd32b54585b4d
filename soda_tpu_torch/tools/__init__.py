"""Tools of the PyTorch/CUDA port: the tuner, the GPU validation gate and
the computation-reuse cost helper."""
