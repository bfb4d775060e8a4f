"""Matching models: the RelCNN backbone and sparse DGMC."""
