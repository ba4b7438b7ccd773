"""The upgrade pipeline's node states and keys that the serving tier
reads (``consts.py``, ``util.py``)."""

from .consts import UpgradeState
from .util import KeyFactory

__all__ = ["KeyFactory", "UpgradeState"]
