"""The error a cluster client raises.

A copy of ``ApiError`` from the JAX package's ``core/client.py``: the
root of the apiserver error family. The serving tier catches it (and
``TimeoutError``) around every cluster read and write, so a client that
hands the tier to a cluster must raise these two for an apiserver
failure.
"""

from __future__ import annotations


class ApiError(RuntimeError):
    """An apiserver call failed with a status (404, 409, 429, 5xx, ...).
    A ``RuntimeError`` subclass, as in the reference."""
