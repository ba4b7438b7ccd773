"""The port's closure passes against the JAX package's: STM001, OBS001-
OBS005, CHS001, CRS001 and WIRE001.

Each is a copy of the reference's pass with the port's paths. They are
held to it in three places (``torch_lint_pairs`` does the pointing, in
the test process only):

- the reference's own tests of these codes in ``tests/test_lint_domain.py``
  run as written, each pass call answered by the reference and checked
  against the twin pointed at the reference's layout;
- the port's real tree, the twin on the repo and on a copy, the
  reference pointed at the port on the copy: nothing, alike;
- copies of the port's tree with one planted offence each: the twin and
  the reference pointed at the port report the same findings, and the
  planted code is among them.
"""

import pytest

from torch_lint_pairs import (PAIRS, PORT, REPO, at_port, copy_port, norm,
                              planted, port_index, ref_index,
                              reference_domain_tests, tools_twin)

# pass function -> its module (the closure passes are project-scope)
PASSES = {
    "STM001": ("state_machine", "run_project"),
    "OBS001": ("obs_check", "run_project"),
    "OBS002": ("obs_check", "run_attribution"),
    "OBS003": ("obs_check", "run_slo"),
    "OBS004": ("obs_check", "run_timeline"),
    "OBS005": ("obs_check", "run_usage"),
    "CHS001": ("chaos_check", "run_project"),
    "CRS001": ("crash_check", "run_project"),
    "WIRE001": ("wire_check", "run_project"),
}


def both(code, root, ref_root=None):
    """(the twin's findings, the reference's pointed at the port) of one
    pass on ``root`` (a path or a ready index; ``ref_root`` the
    reference's, when ``root`` is the twin's index). The twin reads no
    literal in its own ``tools/`` twins (WIRE001, as the reference never
    scans ``tools/``): the reference's findings there are set aside."""
    name, fn = PASSES[code]
    twin, ref = PAIRS[name]
    got = getattr(twin, fn)(root)
    with at_port():
        want = getattr(ref, fn)(root if ref_root is None else ref_root)
    if code == "WIRE001":
        want = [f for f in want if not tools_twin(f[0])]
    return norm(got), norm(want)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every closure pass on the port's tree, off three shared indexes:
    {code: (twin on the repo, twin on a copy, reference on the copy)}."""
    root = copy_port(tmp_path_factory.mktemp("port"))
    repo, copy = port_index.ProjectIndex(REPO), port_index.ProjectIndex(root)
    with at_port():
        ref = ref_index.ProjectIndex(root)
    out = {}
    for code, (name, fn) in PASSES.items():
        got, want = both(code, copy, ref)
        out[code] = (norm(getattr(PAIRS[name][0], fn)(repo)), got, want)
    return out


# ------------------------------------------------ the reference's tests

_REFERENCE = reference_domain_tests(
    ("test_stm001", "test_obs00", "test_chs001", "test_crs001",
     "test_wire001"),
    exclude={})
globals().update({f"test_reference_{k[5:]}": v
                  for k, v in _REFERENCE.items()})


def test_every_reference_closure_test_is_replayed():
    assert len(_REFERENCE) >= 80


# ------------------------------------------------------ the port's tree

@pytest.mark.parametrize("code", sorted(PASSES))
def test_closure_pass_equals_the_reference_on_the_port(code, port_runs):
    on_repo, got, want = port_runs[code]
    assert on_repo == got == want == []


def test_copied_passes_differ_only_in_path_constants():
    """A copy's module-level constants are the reference's except the
    paths, which name the port's files (each of which exists; WIRE001
    also reads the port's tests)."""
    from torch_lint_pairs import PATH_CONSTANTS
    for name in ("state_machine", "wire_check", "chaos_check",
                 "crash_check", "obs_check"):
        twin, ref = PAIRS[name]
        differ = {n for n in vars(ref) if n.isupper() and n != "CODES"
                  and getattr(twin, n, None) != vars(ref)[n]}
        assert differ == PATH_CONSTANTS[name], name
        for const in PATH_CONSTANTS[name]:
            value = getattr(twin, const)
            for path in (value if isinstance(value, tuple) else (value,)):
                assert path.startswith(PORT) or path == "tests", \
                    (name, const)
                assert (REPO / path).exists() or \
                    (REPO / path.rstrip("/")).exists(), (name, path)


# --------------------------------------------- planted offences (copies)

# case -> (file, old, new, the code it plants)
PLANTS = {
    "state-dropped-from-the-diagram": (
        "gen_state_diagram.py",
        '    (UpgradeState.WAIT_FOR_JOBS_REQUIRED, "cordoned"),\n', "",
        "STM001"),
    "verdict-without-a-handler-entry": (
        "health/remediation.py",
        "            HealthVerdict.DEGRADED: self.process_degraded,\n", "",
        "STM001"),
    "state-without-a-stuck-threshold": (
        "obs/journey.py", '    "cordon-required": 300.0,\n', "", "OBS001"),
    "state-label-written-outside-the-choke-point": (
        "health/monitor.py", "    def tick(self) -> Optional[HealthReport]:",
        "    def _rogue(self, node):\n"
        "        self.client.patch_node_metadata(\n"
        "            node, labels={self.keys.state_label: 'x'})\n\n"
        "    def tick(self) -> Optional[HealthReport]:", "OBS001"),
    "state-without-a-window-phase": (
        "obs/attribution.py", '    "cordon-required": "to_gate",\n', "",
        "OBS002"),
    "slo-over-an-unregistered-family": (
        "obs/slo.py", '     "metric": "tpu_operator_phase_duration_seconds",',
        '     "metric": "tpu_operator_phase_duration_secs",', "OBS003"),
    "event-kind-outside-the-catalog": (
        "chaos/injector.py", 'timeline.record_event(kind="chaos-fault",',
        'timeline.record_event(kind="chaos-fault-typo",', "OBS004"),
    "usage-kind-without-a-rank": (
        "obs/usage.py", '    "degraded-frozen": 6,\n', "", "OBS005"),
    "fault-type-without-invariants": (
        "chaos/invariants.py",
        '    "apiserver-latency": ("budget", "journey", "single-leader"),\n',
        "", "CHS001"),
    "durable-write-off-the-crash-registry": (
        "chaos/crash/registry.py",
        '    "drain-intent": ("DRAIN_INTENT_ANNOTATION",),\n', "", "CRS001"),
    "wire-key-spelled-inline": (
        "health/monitor.py", "    def tick(self) -> Optional[HealthReport]:",
        '    ROGUE_KEY = "tpu.dev/rogue"\n\n'
        "    def tick(self) -> Optional[HealthReport]:", "WIRE001"),
}


@pytest.mark.parametrize("case", sorted(PLANTS))
def test_planted_offence_found_alike(case, tmp_path):
    rel, old, new, code = PLANTS[case]
    root = copy_port(tmp_path)
    planted(root, rel, old, new)
    got, want = both(code, root)
    assert got == want
    assert got and {c for _, _, c, _ in got} == {code}, got


def test_every_closure_code_convicts_a_plant():
    assert {p[3] for p in PLANTS.values()} == set(PASSES)
