"""Hand-written CUDA kernels, their wrappers, plain versions and the
dispatch ledger."""
