"""Hand-written CUDA kernels of the port, built at first use (see
:mod:`cigwas_tpu_torch.ops.kernels.build`)."""
