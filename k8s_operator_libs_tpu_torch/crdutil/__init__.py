"""CRD apply/reconcile utilities (reference pkg/crdutil), a copy of the
JAX package's ``crdutil/``."""

from .crdutil import CRDClient, EnsureCRDsError, ensure_crds, walk_crds_dir  # noqa: F401
