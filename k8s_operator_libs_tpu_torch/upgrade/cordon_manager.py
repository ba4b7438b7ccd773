"""CordonManager (reference pkg/upgrade/cordon_manager.go:33-56).

Cordon/uncordon via the drain helper's RunCordonOrUncordon, exactly as the
reference delegates to k8s.io/kubectl/pkg/drain (:39-48).

A copy of the JAX package's ``upgrade/cordon_manager.py``; the port
imports nothing of that package.
"""

from __future__ import annotations

import logging

from ..core.client import Client
from ..core.drain import Helper
from ..core.objects import Node

logger = logging.getLogger(__name__)


class CordonManager:
    def __init__(self, client: Client):
        self._client = client

    def cordon(self, node: Node) -> None:
        Helper(client=self._client).run_cordon_or_uncordon(
            node.metadata.name, True, node=node)
        node.spec.unschedulable = True
        logger.info("cordoned node %s", node.metadata.name)

    def uncordon(self, node: Node) -> None:
        Helper(client=self._client).run_cordon_or_uncordon(
            node.metadata.name, False, node=node)
        node.spec.unschedulable = False
        logger.info("uncordoned node %s", node.metadata.name)
