"""API types (CRD-embeddable policy specs).

A copy of the JAX package's ``api/__init__.py``; the port imports
nothing of that package.
"""

from .v1alpha1 import (  # noqa: F401
    DrainSpec,
    DriverUpgradePolicySpec,
    PodDeletionSpec,
    WaitForCompletionSpec,
    scaled_int_or_percent,
)
