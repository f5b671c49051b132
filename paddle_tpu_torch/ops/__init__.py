"""Tensor ops of the serving and training paths."""
