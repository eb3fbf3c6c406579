"""The ``factory`` key of the JAX package's configurations, read by name."""

from __future__ import annotations

__all__ = ['factory_name']


def factory_name(factory) -> str:
    """The class name of a configuration's ``factory``: a class, a class
    name or a dotted path such as ``tssep_tpu.tasks.losses.LogMAE``. The
    port maps every factory by this name, never by importing the path."""
    if isinstance(factory, type):
        return factory.__name__
    return str(factory).rsplit('.', 1)[-1]
