"""Tensor operations: padded graphs, masked softmax, top-k search."""
