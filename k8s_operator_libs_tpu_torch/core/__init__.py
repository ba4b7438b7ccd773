"""The client boundary the serving tier calls through (``client.py``)."""

from .client import ApiError

__all__ = ["ApiError"]
