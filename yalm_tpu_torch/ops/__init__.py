"""Plain PyTorch ops and the CUDA kernel wrappers (`ops.cuda`)."""
