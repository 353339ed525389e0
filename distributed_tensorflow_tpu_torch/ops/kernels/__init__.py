"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and a launch counter.  Sources live in the package's ``csrc/``;
``_build`` compiles them with nvcc on first use."""
