"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Sources live in ``s2v_torch/csrc``; they are built on first use."""
