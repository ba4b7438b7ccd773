"""Embeddable upgrade-policy CRD spec types.

Mirrors reference api/upgrade/v1alpha1/upgrade_spec.go:27-110 field-for-field,
including kubebuilder defaults (MaxParallelUpgrades=1, MaxUnavailable="25%",
timeouts 300 s). Consumers embed :class:`DriverUpgradePolicySpec` in their own
CRD spec (reference docs/automatic-ofed-upgrade.md:11-39); ``from_dict`` /
``to_dict`` give the YAML round-trip a real CRD would get from the apiserver.

A copy of the JAX package's ``api/v1alpha1.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

IntOrStr = Union[int, str]


def scaled_int_or_percent(value: IntOrStr, total: int, round_up: bool = True) -> int:
    """intstr.GetScaledValueFromIntOrPercent analog (used for maxUnavailable
    at reference upgrade_state.go:395-401, round-up semantics)."""
    if isinstance(value, int):
        return value
    s = value.strip()
    if not s.endswith("%"):
        raise ValueError(f"invalid int-or-percent value {value!r}")
    pct = float(s[:-1])
    scaled = pct * total / 100.0
    return int(math.ceil(scaled)) if round_up else int(math.floor(scaled))


@dataclass
class WaitForCompletionSpec:
    """upgrade_spec.go:52-64. Wait for pods matching ``pod_selector`` to
    finish before upgrading a node; ``timeout_second`` 0 = wait forever."""

    pod_selector: str = ""
    timeout_second: int = 0

    def validate(self) -> None:
        if self.timeout_second < 0:
            raise ValueError("waitForCompletion.timeoutSecond must be >= 0")


@dataclass
class PodDeletionSpec:
    """upgrade_spec.go:67-83. Optional pre-drain deletion of pods picked by
    the consumer-supplied PodDeletionFilter."""

    force: bool = False
    timeout_second: int = 300
    delete_empty_dir: bool = False

    def validate(self) -> None:
        if self.timeout_second < 0:
            raise ValueError("podDeletion.timeoutSecond must be >= 0")


@dataclass
class DrainSpec:
    """upgrade_spec.go:86-110."""

    enable: bool = False
    force: bool = False
    pod_selector: str = ""
    timeout_second: int = 300
    delete_empty_dir: bool = False

    def validate(self) -> None:
        if self.timeout_second < 0:
            raise ValueError("drain.timeoutSecond must be >= 0")


@dataclass
class DriverUpgradePolicySpec:
    """upgrade_spec.go:27-49. ``max_parallel_upgrades`` 0 = unlimited;
    ``max_unavailable`` int or percent string, resolved against total nodes
    with round-up (default "25%")."""

    auto_upgrade: bool = False
    max_parallel_upgrades: int = 1
    max_unavailable: IntOrStr = "25%"
    wait_for_completion: Optional[WaitForCompletionSpec] = None
    pod_deletion: Optional[PodDeletionSpec] = None
    drain: Optional[DrainSpec] = None

    def validate(self) -> None:
        if self.max_parallel_upgrades < 0:
            raise ValueError("maxParallelUpgrades must be >= 0")
        scaled_int_or_percent(self.max_unavailable, 100)  # raises if malformed
        for sub in (self.wait_for_completion, self.pod_deletion, self.drain):
            if sub is not None:
                sub.validate()

    # -- YAML/JSON round-trip ------------------------------------------------

    @classmethod
    def from_dict(cls, d: dict) -> "DriverUpgradePolicySpec":
        spec = cls(
            auto_upgrade=d.get("autoUpgrade", False),
            max_parallel_upgrades=d.get("maxParallelUpgrades", 1),
            max_unavailable=d.get("maxUnavailable", "25%"),
        )
        if "waitForCompletion" in d and d["waitForCompletion"] is not None:
            w = d["waitForCompletion"]
            spec.wait_for_completion = WaitForCompletionSpec(
                pod_selector=w.get("podSelector", ""),
                timeout_second=w.get("timeoutSecond", 0))
        if "podDeletion" in d and d["podDeletion"] is not None:
            p = d["podDeletion"]
            spec.pod_deletion = PodDeletionSpec(
                force=p.get("force", False),
                timeout_second=p.get("timeoutSecond", 300),
                delete_empty_dir=p.get("deleteEmptyDir", False))
        if "drain" in d and d["drain"] is not None:
            dr = d["drain"]
            spec.drain = DrainSpec(
                enable=dr.get("enable", False),
                force=dr.get("force", False),
                pod_selector=dr.get("podSelector", ""),
                timeout_second=dr.get("timeoutSecond", 300),
                delete_empty_dir=dr.get("deleteEmptyDir", False))
        spec.validate()
        return spec

    def to_dict(self) -> dict:
        out: dict = {
            "autoUpgrade": self.auto_upgrade,
            "maxParallelUpgrades": self.max_parallel_upgrades,
            "maxUnavailable": self.max_unavailable,
        }
        if self.wait_for_completion is not None:
            out["waitForCompletion"] = {
                "podSelector": self.wait_for_completion.pod_selector,
                "timeoutSecond": self.wait_for_completion.timeout_second}
        if self.pod_deletion is not None:
            out["podDeletion"] = {
                "force": self.pod_deletion.force,
                "timeoutSecond": self.pod_deletion.timeout_second,
                "deleteEmptyDir": self.pod_deletion.delete_empty_dir}
        if self.drain is not None:
            out["drain"] = {
                "enable": self.drain.enable,
                "force": self.drain.force,
                "podSelector": self.drain.pod_selector,
                "timeoutSecond": self.drain.timeout_second,
                "deleteEmptyDir": self.drain.delete_empty_dir}
        return out
