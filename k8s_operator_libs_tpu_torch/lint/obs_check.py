"""OBS001/OBS002: upgrade-journey observability closure — thresholds,
the transition choke point, and the downtime-attribution phase table can
never drift.

The journey subsystem (``k8s_operator_libs_tpu_torch/obs/journey.py``) sits
BELOW the upgrade package in the layering DAG, so its per-state stuck
thresholds are keyed by the state **wire values**, not by
``UpgradeState.X`` references the type system would check. This cross-file
pass (AST only, no imports) closes that gap in both directions, plus the
choke-point invariant that makes the journey trustworthy:

- **threshold closure**: every string member of ``UpgradeState``
  (``upgrade/consts.py``) must appear as a literal key of
  ``DEFAULT_STUCK_THRESHOLDS`` in obs/journey.py — a new pipeline state
  without a stuck-threshold default is invisible to the detector;
- **no stale thresholds**: a ``DEFAULT_STUCK_THRESHOLDS`` key that is no
  longer any state's wire value is dead configuration (a renamed state
  silently losing its threshold is exactly this, seen from the other
  side);
- **choke point**: the state label and the journey annotation may be
  WRITTEN only by the provider choke point
  (``upgrade/node_state_provider.py``). Any other module patching node
  metadata with the state-label key (``.state_label`` /
  ``STATE_LABEL_FMT`` / a ``*-driver-upgrade-state`` literal) or the
  journey key (``.journey_annotation`` / ``JOURNEY_ANNOTATION_FMT`` / a
  ``*-driver-upgrade.journey`` literal) bypasses the journey recording
  and desynchronizes timeline from label — reads are fine, writes fire.

**OBS002** applies the same closure discipline to the downtime
attribution table (``obs/attribution.py::WINDOW_PHASES``, also keyed by
wire values because obs sits below upgrade):

- every ``UpgradeState`` wire value must have a window-phase entry — a
  new pipeline state with no phase would silently leak its dwell out of
  the attributed unavailability window;
- no stale keys (a renamed state losing its phase, seen from the table
  side);
- every value must be one of the four legal segment names
  (``outside`` / ``to_gate`` / ``gate_to_restart`` / ``after_restart``)
  — a typo'd segment would attribute time to a phase nothing reports.

**OBS003** closes the SLO/alerting layer (``obs/slo.py`` /
``obs/alerts.py``) over the shared metric catalog
(``obs/metrics.py::HELP_TEXTS``):

- every metric family a ``DEFAULT_SLO_SPECS`` objective watches must
  have a HELP_TEXTS entry — a typo'd family silently evaluates to "no
  data" forever;
- every family in the literal ``SLO_GAUGE_FAMILIES`` /
  ``ALERT_GAUGE_FAMILIES`` emitted-family tables must be registered;
- every ``tpu_operator_slo_*`` / ``tpu_operator_alert_*`` HELP entry
  must match an emitted family (no stale catalog entries).

Proven on mutated copies of the real files by
tests/test_torch_lint_closure.py,
like STM001.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Set, Tuple

from .index import as_index
from .registry import Check, register

CODES = {
    "OBS001": "upgrade-journey drift: state without a stuck-threshold "
              "default, stale threshold key, or a state/journey write "
              "outside the provider choke point",
}

CONSTS_PATH = "k8s_operator_libs_tpu_torch/upgrade/consts.py"
JOURNEY_PATH = "k8s_operator_libs_tpu_torch/obs/journey.py"
# the ONLY module allowed to write the state label / journey annotation
CHOKE_PATH = "k8s_operator_libs_tpu_torch/upgrade/node_state_provider.py"
# package trees scanned for choke-point violations
SCAN_ROOTS = ("k8s_operator_libs_tpu_torch",)

# attribute / constant / literal-substring markers of the guarded keys
STATE_KEY_ATTRS = {"state_label"}
STATE_KEY_NAMES = {"STATE_LABEL_FMT"}
STATE_KEY_LITERAL = "-driver-upgrade-state"
JOURNEY_KEY_ATTRS = {"journey_annotation"}
JOURNEY_KEY_NAMES = {"JOURNEY_ANNOTATION_FMT"}
JOURNEY_KEY_LITERAL = "-driver-upgrade.journey"

# node-metadata write methods whose labels/annotations arguments are
# checked (the abstract Client write path plus the provider's own wrappers,
# which a bypasser could call with a raw key)
WRITE_METHODS = {"patch_node_metadata", "change_node_upgrade_annotation",
                 "change_node_state_and_annotations",
                 "change_nodes_state_and_annotations"}

Finding = Tuple[str, int, str, str]


def _state_wire_values(tree: ast.Module) -> Dict[str, Tuple[str, int]]:
    """UpgradeState string members → {member: (wire value, lineno)}."""
    out: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef)
                and node.name == "UpgradeState"):
            continue
        for stmt in node.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)):
                out[stmt.targets[0].id] = (stmt.value.value, stmt.lineno)
    return out


def _threshold_keys(tree: ast.Module) -> Tuple[Dict[str, int], int]:
    """Literal string keys of DEFAULT_STUCK_THRESHOLDS → ({key: lineno},
    lineno of the table itself; 0 when the table is missing)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):  # DEFAULT_...: Dict[...] = {}
            target = node.target
        else:
            continue
        if not (isinstance(target, ast.Name)
                and target.id == "DEFAULT_STUCK_THRESHOLDS"):
            continue
        if not isinstance(node.value, ast.Dict):
            return {}, node.lineno
        keys: Dict[str, int] = {}
        for key in node.value.keys:
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                keys[key.value] = key.lineno
        return keys, node.lineno
    return {}, 0


def _mentions_guarded_key(node: ast.AST, attrs: Set[str], names: Set[str],
                          literal: str) -> bool:
    """Does any subexpression reference one of the guarded keys?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in attrs:
            return True
        if isinstance(n, ast.Name) and n.id in names:
            return True
        if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                and literal in n.value):
            return True
    return False


def _call_payloads(call: ast.Call):
    """(labels-like, annotations-like) argument expressions of a write
    call: keyword args by name, plus every positional after the first
    (node/name) — keys could hide in either payload position."""
    labels = [kw.value for kw in call.keywords if kw.arg == "labels"]
    annos = [kw.value for kw in call.keywords
             if kw.arg in ("annotations",)]
    rest = list(call.args[1:])
    return labels + rest, annos + rest


def _choke_violations(root: Path, rel: str,
                      tree: ast.Module) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in WRITE_METHODS):
            continue
        label_args, anno_args = _call_payloads(node)
        if any(_mentions_guarded_key(a, STATE_KEY_ATTRS, STATE_KEY_NAMES,
                                     STATE_KEY_LITERAL)
               for a in label_args):
            findings.append(
                (rel, node.lineno, "OBS001",
                 f"direct write of the upgrade state-label key outside the "
                 f"choke point ({CHOKE_PATH}) bypasses journey recording"))
        if any(_mentions_guarded_key(a, JOURNEY_KEY_ATTRS,
                                     JOURNEY_KEY_NAMES,
                                     JOURNEY_KEY_LITERAL)
               for a in anno_args):
            findings.append(
                (rel, node.lineno, "OBS001",
                 f"direct write of the journey annotation outside the "
                 f"choke point ({CHOKE_PATH}) desynchronizes the timeline "
                 f"from the state label"))
    return findings


def run_project(root) -> List[Finding]:
    index = as_index(root)
    findings: List[Finding] = []

    members = _state_wire_values(index.tree(CONSTS_PATH))
    if not members:
        return [(CONSTS_PATH, 1, "OBS001",
                 "no UpgradeState string members found (parse drift?)")]
    thresholds, table_line = _threshold_keys(index.tree(JOURNEY_PATH))
    if table_line == 0:
        return [(JOURNEY_PATH, 1, "OBS001",
                 "DEFAULT_STUCK_THRESHOLDS table not found (parse drift?)")]

    wire_values = {v for v, _ in members.values()}
    for name, (value, lineno) in sorted(members.items()):
        if value not in thresholds:
            findings.append(
                (CONSTS_PATH, lineno, "OBS001",
                 f"state {name} ({value!r}) has no stuck-threshold default "
                 f"in DEFAULT_STUCK_THRESHOLDS ({JOURNEY_PATH})"))
    for key, lineno in sorted(thresholds.items()):
        if key not in wire_values:
            findings.append(
                (JOURNEY_PATH, lineno, "OBS001",
                 f"stuck-threshold key {key!r} matches no UpgradeState "
                 f"wire value (renamed or removed state?)"))

    for scan_root in SCAN_ROOTS:
        for rel in index.files_under(scan_root):
            if rel == CHOKE_PATH:
                continue
            try:
                tree = index.tree(rel)
            except SyntaxError:
                continue  # the generic pass reports E999
            findings.extend(_choke_violations(index.root, rel, tree))
    return findings


register(Check(name="obs-journey", codes=CODES, scope="project",
               run=run_project, domain=True))


# --------------------------------------------------- OBS002 (attribution)

ATTRIBUTION_CODES = {
    "OBS002": "downtime-attribution drift: state without a WINDOW_PHASES "
              "entry, stale phase key, or an unknown segment name",
}

ATTRIBUTION_PATH = "k8s_operator_libs_tpu_torch/obs/attribution.py"
ALLOWED_WINDOW_SEGMENTS = {"outside", "to_gate", "gate_to_restart",
                           "after_restart"}


def _window_phase_table(tree: ast.Module
                        ) -> Tuple[Dict[str, Tuple[str, int]], int]:
    """Literal entries of WINDOW_PHASES → ({key: (value, lineno)}, lineno
    of the table; 0 when missing). Non-literal keys/values are skipped
    (and will then fail the closure check, which is the right default)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        else:
            continue
        if not (isinstance(target, ast.Name)
                and target.id == "WINDOW_PHASES"):
            continue
        if not isinstance(node.value, ast.Dict):
            return {}, node.lineno
        entries: Dict[str, Tuple[str, int]] = {}
        for key, value in zip(node.value.keys, node.value.values):
            if (isinstance(key, ast.Constant)
                    and isinstance(key.value, str)
                    and isinstance(value, ast.Constant)
                    and isinstance(value.value, str)):
                entries[key.value] = (value.value, key.lineno)
        return entries, node.lineno
    return {}, 0


def run_attribution(root) -> List[Finding]:
    index = as_index(root)
    findings: List[Finding] = []
    members = _state_wire_values(index.tree(CONSTS_PATH))
    if not members:
        return [(CONSTS_PATH, 1, "OBS002",
                 "no UpgradeState string members found (parse drift?)")]
    table, table_line = _window_phase_table(index.tree(ATTRIBUTION_PATH))
    if table_line == 0:
        return [(ATTRIBUTION_PATH, 1, "OBS002",
                 "WINDOW_PHASES table not found (parse drift?)")]

    wire_values = {v for v, _ in members.values()}
    for name, (value, lineno) in sorted(members.items()):
        if value not in table:
            findings.append(
                (CONSTS_PATH, lineno, "OBS002",
                 f"state {name} ({value!r}) has no window-phase entry in "
                 f"WINDOW_PHASES ({ATTRIBUTION_PATH}) — its dwell would "
                 f"leak out of the attributed unavailability window"))
    for key, (segment, lineno) in sorted(table.items()):
        if key and key not in wire_values:
            findings.append(
                (ATTRIBUTION_PATH, lineno, "OBS002",
                 f"window-phase key {key!r} matches no UpgradeState wire "
                 f"value (renamed or removed state?)"))
        if segment not in ALLOWED_WINDOW_SEGMENTS:
            findings.append(
                (ATTRIBUTION_PATH, lineno, "OBS002",
                 f"window-phase value {segment!r} for key {key!r} is not "
                 f"one of {sorted(ALLOWED_WINDOW_SEGMENTS)}"))
    return findings


register(Check(name="obs-attribution", codes=ATTRIBUTION_CODES,
               scope="project", run=run_attribution, domain=True))


# ------------------------------------------------ OBS003 (SLO/alerting)

SLO_CODES = {
    "OBS003": "SLO/alerting/router/market/flight-recorder metric drift: "
              "an SLO spec references an unregistered metric family, an "
              "emitted slo/alert/router/market/profile family has no "
              "HELP_TEXTS entry, or a tpu_operator_slo_*/"
              "tpu_operator_alert_*/tpu_router_*/tpu_market_*/"
              "tpu_operator_apiserver_*/tpu_operator_tsdb_*/"
              "tpu_operator_obs_scrape_* HELP entry matches no emitted "
              "family",
}

SLO_PATH = "k8s_operator_libs_tpu_torch/obs/slo.py"
ALERTS_PATH = "k8s_operator_libs_tpu_torch/obs/alerts.py"
METRICS_PATH = "k8s_operator_libs_tpu_torch/obs/metrics.py"
# the router tier's emitted-family tables (ROUTER_GAUGE_FAMILIES /
# ROUTER_HISTOGRAM_FAMILIES); absent when a checkout has no serving
# package — the router closure is then skipped entirely, like CHS001
# with no chaos package
ROUTER_METRICS_PATH = "k8s_operator_libs_tpu_torch/serving/metrics.py"
# the tick flight recorder's emitted-family tables (PROFILE_*_FAMILIES:
# apiserver-call accounting + scrape self-metrics); same absent-package
# skip rule
PROFILE_PATH = "k8s_operator_libs_tpu_torch/obs/profile.py"
# the capacity arbiter's emitted-family table (MARKET_GAUGE_FAMILIES);
# same absent-package skip rule as the router closure
MARKET_METRICS_PATH = "k8s_operator_libs_tpu_torch/market/metrics.py"
# HELP entries under these prefixes must correspond to families the
# engine/alert manager actually emits (no stale catalog entries)
SLO_FAMILY_PREFIXES = ("tpu_operator_slo_", "tpu_operator_alert_")
ROUTER_FAMILY_PREFIX = "tpu_router_"
MARKET_FAMILY_PREFIX = "tpu_market_"
PROFILE_FAMILY_PREFIXES = ("tpu_operator_apiserver_",
                           "tpu_operator_tsdb_",
                           "tpu_operator_obs_scrape_")
# the resilient client boundary's emitted-family tables
# (RESILIENCE_GAUGE_FAMILIES / RESILIENCE_COUNTER_FAMILIES) — its
# families share the tpu_operator_apiserver_ prefix with the flight
# recorder, so the profile reverse-check treats both tables as the
# emitted set for that prefix; same absent-module skip rule
RESILIENCE_PATH = "k8s_operator_libs_tpu_torch/core/resilience.py"
# the request flight recorder's emitted-family tables
# (REQTRACE_GAUGE_FAMILIES / REQTRACE_HISTOGRAM_FAMILIES) — its families
# share the tpu_router_ prefix with the router tier, so the router
# reverse-check treats the union of both modules' tables as the emitted
# set for that prefix; same absent-module skip rule
REQTRACE_PATH = "k8s_operator_libs_tpu_torch/obs/reqtrace.py"
# the cause engine's emitted-family table (CAUSES_COUNTER_FAMILIES) —
# its counter shares the tpu_operator_alert_ prefix with the alert
# manager, so it joins the slo/alert closure; same absent-module skip
SLO_CAUSES_PATH = "k8s_operator_libs_tpu_torch/obs/causes.py"


def _help_text_keys(tree: ast.Module) -> Tuple[Dict[str, int], int]:
    """Literal string keys of HELP_TEXTS → ({key: lineno}, table lineno;
    0 when missing)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        else:
            continue
        if not (isinstance(target, ast.Name) and target.id == "HELP_TEXTS"):
            continue
        if not isinstance(node.value, ast.Dict):
            return {}, node.lineno
        keys: Dict[str, int] = {}
        for key in node.value.keys:
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                keys[key.value] = key.lineno
        return keys, node.lineno
    return {}, 0


def _string_tuple(tree: ast.Module, name: str
                  ) -> Tuple[Dict[str, int], int]:
    """Literal string elements of a module-level tuple/list assignment →
    ({value: lineno}, assignment lineno; 0 when missing)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        else:
            continue
        if not (isinstance(target, ast.Name) and target.id == name):
            continue
        if not isinstance(node.value, (ast.Tuple, ast.List)):
            return {}, node.lineno
        out: Dict[str, int] = {}
        for elt in node.value.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out[elt.value] = elt.lineno
        return out, node.lineno
    return {}, 0


def _default_spec_metrics(tree: ast.Module
                          ) -> Tuple[List[Tuple[str, str, int]], int]:
    """(slo name, metric family, lineno) triples from the literal
    DEFAULT_SLO_SPECS table; table lineno (0 when missing)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        else:
            continue
        if not (isinstance(target, ast.Name)
                and target.id == "DEFAULT_SLO_SPECS"):
            continue
        if not isinstance(node.value, (ast.Tuple, ast.List)):
            return [], node.lineno
        out: List[Tuple[str, str, int]] = []
        for elt in node.value.elts:
            if not isinstance(elt, ast.Dict):
                continue
            entry: Dict[str, Tuple[str, int]] = {}
            for key, value in zip(elt.keys, elt.values):
                if (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)
                        and isinstance(value, ast.Constant)
                        and isinstance(value.value, str)):
                    entry[key.value] = (value.value, value.lineno)
            if "metric" in entry:
                metric, lineno = entry["metric"]
                name = entry.get("name", ("?", lineno))[0]
                out.append((name, metric, lineno))
        return out, node.lineno
    return [], 0


def run_slo(root) -> List[Finding]:
    index = as_index(root)
    findings: List[Finding] = []

    help_keys, help_line = _help_text_keys(index.tree(METRICS_PATH))
    if help_line == 0:
        return [(METRICS_PATH, 1, "OBS003",
                 "HELP_TEXTS table not found (parse drift?)")]
    specs, specs_line = _default_spec_metrics(index.tree(SLO_PATH))
    if specs_line == 0:
        return [(SLO_PATH, 1, "OBS003",
                 "DEFAULT_SLO_SPECS table not found (parse drift?)")]
    slo_fams, slo_fams_line = _string_tuple(
        index.tree(SLO_PATH), "SLO_GAUGE_FAMILIES")
    alert_fams, alert_fams_line = _string_tuple(
        index.tree(ALERTS_PATH), "ALERT_GAUGE_FAMILIES")
    if slo_fams_line == 0:
        return [(SLO_PATH, 1, "OBS003",
                 "SLO_GAUGE_FAMILIES table not found (parse drift?)")]
    if alert_fams_line == 0:
        return [(ALERTS_PATH, 1, "OBS003",
                 "ALERT_GAUGE_FAMILIES table not found (parse drift?)")]

    # direction 1: every metric an SLO spec watches must be a registered
    # family — a typo'd family silently evaluates to "no data" forever
    for name, metric, lineno in specs:
        if metric not in help_keys:
            findings.append(
                (SLO_PATH, lineno, "OBS003",
                 f"SLO {name!r} references metric family {metric!r} with "
                 f"no HELP_TEXTS entry ({METRICS_PATH}) — unregistered "
                 f"families never appear in any exposition"))

    # direction 1b: every family the engine/alert manager emits must be
    # registered, or its HELP falls back to underscores-to-spaces
    emitted = {**{f: (SLO_PATH, ln) for f, ln in slo_fams.items()},
               **{f: (ALERTS_PATH, ln) for f, ln in alert_fams.items()}}
    # the cause engine's counter shares the tpu_operator_alert_ prefix,
    # so its emitted-family table joins the same closure (skipped when
    # the checkout carries no causes module)
    if index.exists(SLO_CAUSES_PATH):
        causes_fams, causes_line = _string_tuple(
            index.tree(SLO_CAUSES_PATH), "CAUSES_COUNTER_FAMILIES")
        if causes_line == 0:
            findings.append(
                (SLO_CAUSES_PATH, 1, "OBS003",
                 "CAUSES_COUNTER_FAMILIES table not found "
                 "(parse drift?)"))
        emitted.update({f: (SLO_CAUSES_PATH, ln)
                        for f, ln in causes_fams.items()})
    for family, (rel, lineno) in sorted(emitted.items()):
        if family not in help_keys:
            findings.append(
                (rel, lineno, "OBS003",
                 f"emitted gauge family {family!r} has no HELP_TEXTS "
                 f"entry ({METRICS_PATH})"))

    # direction 2: no stale catalog entries — a tpu_operator_slo_* /
    # tpu_operator_alert_* HELP entry whose family nothing emits is a
    # renamed/removed gauge seen from the registry side
    for key, lineno in sorted(help_keys.items()):
        if key.startswith(SLO_FAMILY_PREFIXES) and key not in emitted:
            findings.append(
                (METRICS_PATH, lineno, "OBS003",
                 f"HELP_TEXTS entry {key!r} matches no emitted family in "
                 f"SLO_GAUGE_FAMILIES ({SLO_PATH}), ALERT_GAUGE_FAMILIES "
                 f"({ALERTS_PATH}), or CAUSES_COUNTER_FAMILIES "
                 f"({SLO_CAUSES_PATH}) (renamed or removed gauge?)"))

    # request flight recorder: obs/reqtrace.py's emitted-family tables
    # close over HELP_TEXTS both ways (skipped when the checkout carries
    # no reqtrace module). Collected BEFORE the router block so the
    # shared tpu_router_ prefix check can treat the union of both
    # modules' tables as the emitted set.
    reqtrace_emitted: Dict[str, int] = {}
    if index.exists(REQTRACE_PATH):
        reqtrace_tree = index.tree(REQTRACE_PATH)
        for table in ("REQTRACE_GAUGE_FAMILIES",
                      "REQTRACE_HISTOGRAM_FAMILIES"):
            fams, fams_line = _string_tuple(reqtrace_tree, table)
            if fams_line == 0:
                findings.append(
                    (REQTRACE_PATH, 1, "OBS003",
                     f"{table} table not found (parse drift?)"))
                continue
            reqtrace_emitted.update(fams)
        for family, lineno in sorted(reqtrace_emitted.items()):
            if family not in help_keys:
                findings.append(
                    (REQTRACE_PATH, lineno, "OBS003",
                     f"emitted request-trace family {family!r} has no "
                     f"HELP_TEXTS entry ({METRICS_PATH})"))

    # router tier: the serving/metrics.py emitted-family tables close
    # over HELP_TEXTS exactly like the slo/alert tables (skipped when
    # the checkout carries no serving package)
    if index.exists(ROUTER_METRICS_PATH):
        router_tree = index.tree(ROUTER_METRICS_PATH)
        router_emitted: Dict[str, int] = {}
        for table in ("ROUTER_GAUGE_FAMILIES",
                      "ROUTER_HISTOGRAM_FAMILIES"):
            fams, fams_line = _string_tuple(router_tree, table)
            if fams_line == 0:
                findings.append(
                    (ROUTER_METRICS_PATH, 1, "OBS003",
                     f"{table} table not found (parse drift?)"))
                continue
            router_emitted.update(fams)
        for family, lineno in sorted(router_emitted.items()):
            if family not in help_keys:
                findings.append(
                    (ROUTER_METRICS_PATH, lineno, "OBS003",
                     f"emitted router family {family!r} has no "
                     f"HELP_TEXTS entry ({METRICS_PATH})"))
        for key, lineno in sorted(help_keys.items()):
            if (key.startswith(ROUTER_FAMILY_PREFIX)
                    and key not in router_emitted
                    and key not in reqtrace_emitted):
                findings.append(
                    (METRICS_PATH, lineno, "OBS003",
                     f"HELP_TEXTS entry {key!r} matches no emitted "
                     f"family in ROUTER_GAUGE_FAMILIES or "
                     f"ROUTER_HISTOGRAM_FAMILIES ({ROUTER_METRICS_PATH}) "
                     f"or the REQTRACE_*_FAMILIES tables "
                     f"({REQTRACE_PATH}) (renamed or removed router "
                     f"metric?)"))

    # capacity market: the market/metrics.py emitted-family table closes
    # over HELP_TEXTS both ways like the router tables (skipped when the
    # checkout carries no market package)
    if index.exists(MARKET_METRICS_PATH):
        market_tree = index.tree(MARKET_METRICS_PATH)
        market_emitted, market_line = _string_tuple(
            market_tree, "MARKET_GAUGE_FAMILIES")
        if market_line == 0:
            findings.append(
                (MARKET_METRICS_PATH, 1, "OBS003",
                 "MARKET_GAUGE_FAMILIES table not found (parse drift?)"))
        for family, lineno in sorted(market_emitted.items()):
            if family not in help_keys:
                findings.append(
                    (MARKET_METRICS_PATH, lineno, "OBS003",
                     f"emitted market family {family!r} has no "
                     f"HELP_TEXTS entry ({METRICS_PATH})"))
        for key, lineno in sorted(help_keys.items()):
            if (key.startswith(MARKET_FAMILY_PREFIX)
                    and key not in market_emitted):
                findings.append(
                    (METRICS_PATH, lineno, "OBS003",
                     f"HELP_TEXTS entry {key!r} matches no emitted "
                     f"family in MARKET_GAUGE_FAMILIES "
                     f"({MARKET_METRICS_PATH}) (renamed or removed "
                     f"market metric?)"))

    # resilient client boundary: core/resilience.py's emitted-family
    # tables close over HELP_TEXTS both ways (skipped when the checkout
    # carries no resilience module). Collected BEFORE the profile block
    # so the shared tpu_operator_apiserver_ prefix check can treat the
    # union of both modules' tables as the emitted set.
    resilience_emitted: Dict[str, int] = {}
    if index.exists(RESILIENCE_PATH):
        resilience_tree = index.tree(RESILIENCE_PATH)
        for table in ("RESILIENCE_GAUGE_FAMILIES",
                      "RESILIENCE_COUNTER_FAMILIES"):
            fams, fams_line = _string_tuple(resilience_tree, table)
            if fams_line == 0:
                findings.append(
                    (RESILIENCE_PATH, 1, "OBS003",
                     f"{table} table not found (parse drift?)"))
                continue
            resilience_emitted.update(fams)
        for family, lineno in sorted(resilience_emitted.items()):
            if family not in help_keys:
                findings.append(
                    (RESILIENCE_PATH, lineno, "OBS003",
                     f"emitted resilience family {family!r} has no "
                     f"HELP_TEXTS entry ({METRICS_PATH})"))

    # flight recorder: the obs/profile.py emitted-family tables close
    # over HELP_TEXTS both ways too (skipped when the checkout carries
    # no profile module)
    if index.exists(PROFILE_PATH):
        profile_tree = index.tree(PROFILE_PATH)
        profile_emitted: Dict[str, int] = {}
        for table in ("PROFILE_HISTOGRAM_FAMILIES",
                      "PROFILE_COUNTER_FAMILIES",
                      "PROFILE_GAUGE_FAMILIES"):
            fams, fams_line = _string_tuple(profile_tree, table)
            if fams_line == 0:
                findings.append(
                    (PROFILE_PATH, 1, "OBS003",
                     f"{table} table not found (parse drift?)"))
                continue
            profile_emitted.update(fams)
        for family, lineno in sorted(profile_emitted.items()):
            if family not in help_keys:
                findings.append(
                    (PROFILE_PATH, lineno, "OBS003",
                     f"emitted flight-recorder family {family!r} has no "
                     f"HELP_TEXTS entry ({METRICS_PATH})"))
        for key, lineno in sorted(help_keys.items()):
            if (key.startswith(PROFILE_FAMILY_PREFIXES)
                    and key not in profile_emitted
                    and key not in resilience_emitted):
                findings.append(
                    (METRICS_PATH, lineno, "OBS003",
                     f"HELP_TEXTS entry {key!r} matches no emitted "
                     f"family in the PROFILE_*_FAMILIES tables "
                     f"({PROFILE_PATH}) or the RESILIENCE_*_FAMILIES "
                     f"tables ({RESILIENCE_PATH}) (renamed or removed "
                     f"metric?)"))
    return findings


register(Check(name="obs-slo", codes=SLO_CODES, scope="project",
               run=run_slo, domain=True))


# -------------------------------------------- OBS004 (fleet timeline)

TIMELINE_CODES = {
    "OBS004": "fleet-timeline drift: a record_event() call uses a "
              "non-literal or uncataloged event kind, an EVENT_KINDS "
              "entry has no emitter (and no `# obs: allow` hatch), or "
              "a CAUSE_PRIORS key names no cataloged kind",
}

TIMELINE_PATH = "k8s_operator_libs_tpu_torch/obs/timeline.py"
CAUSES_PATH = "k8s_operator_libs_tpu_torch/obs/causes.py"
# kinds a checkout may legitimately catalog without an in-tree emitter
# carry `# obs: allow — <why>` on their catalog line
TIMELINE_HATCH = "# obs: allow"


def _cause_prior_keys(tree: ast.Module) -> Tuple[Dict[str, int], int]:
    """Literal string keys of CAUSE_PRIORS → ({key: lineno}, table
    lineno; 0 when missing)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        else:
            continue
        if not (isinstance(target, ast.Name)
                and target.id == "CAUSE_PRIORS"):
            continue
        if not isinstance(node.value, ast.Dict):
            return {}, node.lineno
        keys: Dict[str, int] = {}
        for key in node.value.keys:
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                keys[key.value] = key.lineno
        return keys, node.lineno
    return {}, 0


def _record_event_kinds(tree: ast.Module
                        ) -> Tuple[List[Tuple[str, int]], List[int]]:
    """Every ``record_event(...)`` call site → ([(literal kind, lineno)],
    [linenos of calls whose kind= is absent or not a string literal])."""
    literals: List[Tuple[str, int]] = []
    bad: List[int] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = (func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else None)
        if name != "record_event":
            continue
        kind = next((kw.value for kw in node.keywords
                     if kw.arg == "kind"), None)
        if (isinstance(kind, ast.Constant)
                and isinstance(kind.value, str)):
            literals.append((kind.value, node.lineno))
        else:
            bad.append(node.lineno)
    return literals, bad


def run_timeline(root) -> List[Finding]:
    index = as_index(root)
    findings: List[Finding] = []
    if not index.exists(TIMELINE_PATH):
        return findings  # no timeline module in this checkout — skip

    catalog, catalog_line = _string_tuple(index.tree(TIMELINE_PATH),
                                          "EVENT_KINDS")
    if catalog_line == 0:
        return [(TIMELINE_PATH, 1, "OBS004",
                 "EVENT_KINDS catalog not found (parse drift?)")]

    # direction 1: every record_event() call site names a cataloged kind
    # as a STRING LITERAL — a variable kind defeats the closure (the
    # store rejects unknown kinds at runtime, but only this pass proves
    # it can never trip), and a typo'd literal is an event the cause
    # engine will never see
    emitters: Dict[str, List[Tuple[str, int]]] = {}
    for scan_root in SCAN_ROOTS:
        for rel in index.files_under(scan_root):
            try:
                tree = index.tree(rel)
            except SyntaxError:
                continue  # the generic pass reports E999
            literals, bad = _record_event_kinds(tree)
            for kind, lineno in literals:
                if rel == TIMELINE_PATH:
                    continue  # the store's own internals, not an emitter
                emitters.setdefault(kind, []).append((rel, lineno))
                if kind not in catalog:
                    findings.append(
                        (rel, lineno, "OBS004",
                         f"record_event() kind {kind!r} is not in the "
                         f"EVENT_KINDS catalog ({TIMELINE_PATH}) — it "
                         f"would raise ValueError on the first emit"))
            for lineno in bad:
                if rel == TIMELINE_PATH:
                    continue
                findings.append(
                    (rel, lineno, "OBS004",
                     "record_event() must pass kind= as a string "
                     "literal at the call site — a computed kind "
                     "defeats the catalog closure"))

    # direction 2: every cataloged kind has at least one emitter, or
    # carries the `# obs: allow — <why>` hatch on its catalog line — a
    # kind nothing emits is dead vocabulary the cause priors and docs
    # still pretend exists
    lines = index.lines(TIMELINE_PATH)
    for kind, lineno in sorted(catalog.items()):
        if kind in emitters:
            continue
        line = lines[lineno - 1] if lineno - 1 < len(lines) else ""
        if TIMELINE_HATCH in line:
            continue
        findings.append(
            (TIMELINE_PATH, lineno, "OBS004",
             f"EVENT_KINDS entry {kind!r} has no record_event() emitter "
             f"anywhere under {'/'.join(SCAN_ROOTS)} (add the emitter, "
             f"remove the kind, or hatch the line with "
             f"`{TIMELINE_HATCH} — <why>`)"))

    # the cause engine's prior table is vocabulary over the same catalog
    if index.exists(CAUSES_PATH):
        priors, priors_line = _cause_prior_keys(index.tree(CAUSES_PATH))
        if priors_line == 0:
            findings.append(
                (CAUSES_PATH, 1, "OBS004",
                 "CAUSE_PRIORS table not found (parse drift?)"))
        for kind, lineno in sorted(priors.items()):
            if kind not in catalog:
                findings.append(
                    (CAUSES_PATH, lineno, "OBS004",
                     f"CAUSE_PRIORS key {kind!r} is not in the "
                     f"EVENT_KINDS catalog ({TIMELINE_PATH}) — a prior "
                     f"for a kind that can never be recorded"))
    return findings


register(Check(name="obs-timeline", codes=TIMELINE_CODES, scope="project",
               run=run_timeline, domain=True))


# -------------------------------------------- OBS005 (fleet usage ledger)

USAGE_CODES = {
    "OBS005": "fleet-ledger drift: USAGE_KINDS and KIND_PRIORITY "
              "disagree, a _bid() attribution site claims a non-literal "
              "or uncataloged kind, a cataloged kind is never claimed "
              "anywhere (and has no `# obs: allow` hatch), or the "
              "USAGE_*_FAMILIES tables and the tpu_operator_usage_* "
              "HELP_TEXTS entries disagree",
}

USAGE_PATH = "k8s_operator_libs_tpu_torch/obs/usage.py"
# HELP entries under this prefix must correspond to families the usage
# meter actually emits (and vice versa) — the OBS003 discipline, scoped
# to the fleet ledger's own prefix
USAGE_HELP_PREFIX = "tpu_operator_usage_"
# family tables carry unprefixed names; render() prepends the operator
# prefix, so the closure compares against prefix + family
USAGE_METRIC_PREFIX = "tpu_operator_"
USAGE_HATCH = "# obs: allow"


def _dict_literal_keys(tree: ast.Module, name: str
                       ) -> Tuple[Dict[str, int], int]:
    """Literal string keys of a module-level dict assignment →
    ({key: lineno}, assignment lineno; 0 when missing)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        else:
            continue
        if not (isinstance(target, ast.Name) and target.id == name):
            continue
        if not isinstance(node.value, ast.Dict):
            return {}, node.lineno
        keys: Dict[str, int] = {}
        for key in node.value.keys:
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                keys[key.value] = key.lineno
        return keys, node.lineno
    return {}, 0


def _bid_kinds(tree: ast.Module
               ) -> Tuple[List[Tuple[str, int]], List[int]]:
    """Every ``_bid(...)`` attribution site → ([(literal kind, lineno)],
    [linenos of calls whose kind is absent or not a string literal])."""
    literals: List[Tuple[str, int]] = []
    bad: List[int] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = (func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else None)
        if name != "_bid":
            continue
        kind = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "kind"), None)
        if isinstance(kind, ast.Constant) and isinstance(kind.value, str):
            literals.append((kind.value, node.lineno))
        else:
            bad.append(node.lineno)
    return literals, bad


def run_usage(root) -> List[Finding]:
    index = as_index(root)
    findings: List[Finding] = []
    if not index.exists(USAGE_PATH):
        return findings  # no fleet ledger in this checkout — skip

    usage_tree = index.tree(USAGE_PATH)
    catalog, catalog_line = _string_tuple(usage_tree, "USAGE_KINDS")
    if catalog_line == 0:
        return [(USAGE_PATH, 1, "OBS005",
                 "USAGE_KINDS catalog not found (parse drift?)")]
    priority, priority_line = _dict_literal_keys(usage_tree,
                                                 "KIND_PRIORITY")
    if priority_line == 0:
        return [(USAGE_PATH, 1, "OBS005",
                 "KIND_PRIORITY table not found (parse drift?)")]

    # closure 1: the catalog and the priority sweep agree both ways — a
    # kind without a rank makes _bid() raise at runtime; a rank without
    # a kind is a sweep entry nothing can ever claim
    for kind, lineno in sorted(catalog.items()):
        if kind not in priority:
            findings.append(
                (USAGE_PATH, lineno, "OBS005",
                 f"USAGE_KINDS entry {kind!r} has no KIND_PRIORITY rank "
                 f"— _bid({kind!r}) would raise on the first claim"))
    for kind, lineno in sorted(priority.items()):
        if kind not in catalog:
            findings.append(
                (USAGE_PATH, lineno, "OBS005",
                 f"KIND_PRIORITY key {kind!r} is not in the USAGE_KINDS "
                 f"catalog (renamed or removed kind?)"))

    # closure 2: every _bid() site claims a cataloged kind as a STRING
    # LITERAL (the record_event discipline — a computed kind defeats the
    # closure), and every cataloged kind is claimed somewhere, or
    # carries the `# obs: allow — <why>` hatch on its catalog line
    claimed: Dict[str, List[Tuple[str, int]]] = {}
    for scan_root in SCAN_ROOTS:
        for rel in index.files_under(scan_root):
            try:
                tree = index.tree(rel)
            except SyntaxError:
                continue  # the generic pass reports E999
            literals, bad = _bid_kinds(tree)
            for kind, lineno in literals:
                claimed.setdefault(kind, []).append((rel, lineno))
                if kind not in catalog:
                    findings.append(
                        (rel, lineno, "OBS005",
                         f"_bid() kind {kind!r} is not in the "
                         f"USAGE_KINDS catalog ({USAGE_PATH}) — it "
                         f"would raise ValueError on the first claim"))
            for lineno in bad:
                findings.append(
                    (rel, lineno, "OBS005",
                     "_bid() must pass the kind as a string literal at "
                     "the call site — a computed kind defeats the "
                     "catalog closure"))
    lines = index.lines(USAGE_PATH)
    for kind, lineno in sorted(catalog.items()):
        if kind in claimed:
            continue
        line = lines[lineno - 1] if lineno - 1 < len(lines) else ""
        if USAGE_HATCH in line:
            continue
        findings.append(
            (USAGE_PATH, lineno, "OBS005",
             f"USAGE_KINDS entry {kind!r} is never claimed by any "
             f"_bid() site under {'/'.join(SCAN_ROOTS)} — capacity can "
             f"never be attributed to it (add the claim, remove the "
             f"kind, or hatch the line with `{USAGE_HATCH} — <why>`)"))

    # closure 3: the meter's emitted-family tables and the
    # tpu_operator_usage_* HELP entries agree both ways (OBS003's
    # discipline, scoped to the fleet ledger's prefix)
    help_keys, help_line = _help_text_keys(index.tree(METRICS_PATH))
    if help_line == 0:
        findings.append((METRICS_PATH, 1, "OBS005",
                         "HELP_TEXTS table not found (parse drift?)"))
        return findings
    emitted: Dict[str, int] = {}
    for table in ("USAGE_COUNTER_FAMILIES", "USAGE_GAUGE_FAMILIES"):
        fams, fams_line = _string_tuple(usage_tree, table)
        if fams_line == 0:
            findings.append(
                (USAGE_PATH, 1, "OBS005",
                 f"{table} table not found (parse drift?)"))
            continue
        emitted.update(fams)
    full = {USAGE_METRIC_PREFIX + family: lineno
            for family, lineno in emitted.items()}
    for family, lineno in sorted(full.items()):
        if family not in help_keys:
            findings.append(
                (USAGE_PATH, lineno, "OBS005",
                 f"emitted usage family {family!r} has no HELP_TEXTS "
                 f"entry ({METRICS_PATH})"))
    for key, lineno in sorted(help_keys.items()):
        if key.startswith(USAGE_HELP_PREFIX) and key not in full:
            findings.append(
                (METRICS_PATH, lineno, "OBS005",
                 f"HELP_TEXTS entry {key!r} matches no emitted family "
                 f"in the USAGE_*_FAMILIES tables ({USAGE_PATH}) "
                 f"(renamed or removed usage metric?)"))
    return findings


register(Check(name="obs-usage", codes=USAGE_CODES, scope="project",
               run=run_usage, domain=True))
