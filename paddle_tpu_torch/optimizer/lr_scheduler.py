"""Learning-rate schedules (counterpart of
``paddle_tpu/optimizer/lr_scheduler.py``): ``constant`` and ``resolve``.
The decay schedules come with a later slice."""

from __future__ import annotations


def constant(lr):
    return lambda step: float(lr)


def resolve(lr):
    """Accept float | callable; return callable(step) -> lr."""
    return lr if callable(lr) else constant(lr)
