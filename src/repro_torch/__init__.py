"""PyTorch port of the SONIC serving system (the JAX package ``repro`` is the
reference it is held against).  Runs on an NVIDIA H100 through hand-written
CUDA kernels; every entry point takes the CPU only when asked."""
