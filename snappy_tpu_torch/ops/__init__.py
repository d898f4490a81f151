"""Device kernels of the PyTorch/CUDA port and the host-facing API over them."""
