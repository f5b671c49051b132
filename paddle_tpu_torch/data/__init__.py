"""Datasets of the port's paths (counterpart of ``paddle_tpu/data``)."""
