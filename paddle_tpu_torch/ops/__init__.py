"""Tensor ops of the serving path."""
