"""Correspondence metrics."""
