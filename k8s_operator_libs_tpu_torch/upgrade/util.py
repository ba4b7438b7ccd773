"""Per-component key names (a copy of ``KeyFactory`` from the JAX
package's ``upgrade/util.py``, cut to the state label the serving tier
reads)."""

from __future__ import annotations

from . import consts


class KeyFactory:
    """The label and annotation keys of one managed component ("libtpu",
    "gpu", ...)."""

    def __init__(self, component: str, domain: str = consts.DEFAULT_DOMAIN):
        if not component:
            raise ValueError("component name must be non-empty")
        self.component = component
        self.domain = domain

    def _fmt(self, template: str) -> str:
        return template.format(domain=self.domain, component=self.component)

    @property
    def state_label(self) -> str:
        return self._fmt(consts.STATE_LABEL_FMT)
