"""Synthetic matching workloads (NumPy)."""
