"""Generate docs/images/gpu-driver-upgrade-state-diagram.svg.

The port's twin of the JAX package's ``tools/gen_state_diagram.py``: it
renders the GPU driver's rolling-upgrade state machine from the port's own
state list, so the picture cannot rot: states come from the port's
``upgrade/consts.py:UpgradeState``, the edge list mirrors ApplyState's fixed
processing order (``upgrade/upgrade_state.py``). A multi-node slice is the
NVLink clique ``gpu/scheduler.py`` places a job on.

Run: python -m k8s_operator_libs_tpu_torch.gen_state_diagram [out]
(writes the SVG in place by default; it is checked into git so docs render
without running anything).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

from .upgrade.consts import UpgradeState

REPO = Path(__file__).resolve().parent.parent
DEFAULT_OUT = REPO / "docs" / "images" / "gpu-driver-upgrade-state-diagram.svg"

# main pipeline, in ApplyState processing order
PIPELINE = [
    ("unknown", "node label absent"),
    (UpgradeState.UPGRADE_REQUIRED, "driver pod hash != DS hash,\nupgrade-requested, or safe-load wait"),
    (UpgradeState.CORDON_REQUIRED, "admitted by throttle\n(whole clique at once)"),
    (UpgradeState.WAIT_FOR_JOBS_REQUIRED, "cordoned"),
    (UpgradeState.POD_DELETION_REQUIRED, "jobs finished\n(optional state)"),
    (UpgradeState.DRAIN_REQUIRED, "workload pods evicted"),
    (UpgradeState.POD_RESTART_REQUIRED, "drained; waits at clique\nrestart barrier"),
    (UpgradeState.VALIDATION_REQUIRED, "driver pod in sync + ready\n(optional state)"),
    (UpgradeState.UNCORDON_REQUIRED, "validated; waits at clique\nuncordon barrier"),
    (UpgradeState.DONE, "uncordoned"),
]

W, H = 1180, 560
BOX_W, BOX_H = 196, 44
COL_GAP, ROW_GAP = 40, 96
PER_ROW = 5
FAIL_Y = 430

STATE_FILL = "#eef4fb"
STATE_EDGE = "#3b6ea5"
FAIL_FILL = "#fdecec"
FAIL_EDGE = "#b3362c"
TEXT = "#1c2733"
EDGE = "#51606f"


def esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;"))


def box(x, y, label, fill, edge):
    return (
        f'<rect x="{x}" y="{y}" width="{BOX_W}" height="{BOX_H}" rx="8" '
        f'fill="{fill}" stroke="{edge}" stroke-width="1.6"/>' +
        f'<text x="{x + BOX_W / 2}" y="{y + BOX_H / 2 + 5}" '
        f'text-anchor="middle" font-family="Helvetica,Arial,sans-serif" '
        f'font-size="14" font-weight="bold" fill="{TEXT}">{esc(label)}</text>')


def small_text(x, y, lines, anchor="middle"):
    out = []
    for i, ln in enumerate(lines):
        out.append(
            f'<text x="{x}" y="{y + i * 13}" text-anchor="{anchor}" '
            f'font-family="Helvetica,Arial,sans-serif" font-size="10.5" '
            f'fill="{EDGE}">{esc(ln)}</text>')
    return "".join(out)


def arrow(x1, y1, x2, y2):
    return (f'<line x1="{x1}" y1="{y1}" x2="{x2}" y2="{y2}" stroke="{EDGE}" '
            f'stroke-width="1.5" marker-end="url(#arr)"/>')


def main(out_path: Optional[str] = None) -> None:
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" '
        f'viewBox="0 0 {W} {H}" font-family="Helvetica,Arial,sans-serif">',
        '<defs><marker id="arr" viewBox="0 0 10 10" refX="9" refY="5" '
        'markerWidth="7" markerHeight="7" orient="auto-start-reverse">'
        f'<path d="M 0 0 L 10 5 L 0 10 z" fill="{EDGE}"/></marker></defs>',
        f'<rect width="{W}" height="{H}" fill="white"/>',
        f'<text x="{W / 2}" y="30" text-anchor="middle" font-size="18" '
        f'font-weight="bold" fill="{TEXT}">NVIDIA GPU driver / device-plugin '
        'rolling-upgrade state machine</text>',
        f'<text x="{W / 2}" y="50" text-anchor="middle" font-size="11.5" '
        f'fill="{EDGE}">node label '
        f'{esc("<domain>/<component>-driver-upgrade-state")}; NVLink-clique-'
        'atomic barriers at cordon admission, pod restart, and uncordon</text>',
    ]
    pos = {}
    for i, (state, _) in enumerate(PIPELINE):
        row, col = divmod(i, PER_ROW)
        if row % 2 == 1:  # serpentine: reverse odd rows
            col = PER_ROW - 1 - col
        x = 30 + col * (BOX_W + COL_GAP)
        y = 80 + row * (BOX_H + ROW_GAP)
        pos[state] = (x, y)
        parts.append(box(x, y, state or "unknown", STATE_FILL, STATE_EDGE))

    for i in range(len(PIPELINE) - 1):
        a, cond = PIPELINE[i][0], PIPELINE[i + 1][1]
        b = PIPELINE[i + 1][0]
        ax, ay = pos[a]
        bx, by = pos[b]
        lines = cond.split("\n")
        if ay == by:  # same row
            if bx > ax:
                parts.append(arrow(ax + BOX_W, ay + BOX_H / 2, bx - 4,
                                   by + BOX_H / 2))
                cx = (ax + BOX_W + bx) / 2
            else:
                parts.append(arrow(ax, ay + BOX_H / 2, bx + BOX_W + 4,
                                   by + BOX_H / 2))
                cx = (ax + bx + BOX_W) / 2
            parts.append(small_text(cx, ay + BOX_H / 2 - 10 - 13 * (len(lines) - 1),
                                    lines))
        else:  # row change: vertical hop
            parts.append(arrow(ax + BOX_W / 2, ay + BOX_H, bx + BOX_W / 2,
                               by - 4))
            parts.append(small_text(ax + BOX_W / 2 + 8, (ay + BOX_H + by) / 2 - 2,
                                    lines, anchor="start"))

    # health-remediation entry: an unhealthy-persistent clique is
    # quarantined, then injected into THIS pipeline via the
    # upgrade-requested annotation — repairs share the machine's
    # clique-atomic admission and maxUnavailable budget
    hx, hy = 30, FAIL_Y
    parts.append(box(hx, hy, "health: quarantine", STATE_FILL, FAIL_EDGE))
    parts.append(small_text(
        hx + BOX_W / 2, hy + BOX_H + 18,
        ["fleet-health verdict unhealthy-persistent:",
         "clique cordoned + tainted, then upgrade-requested",
         "on every member — repair rides this pipeline",
         "(shared availability budget; health/remediation.py)"]))
    ux0, uy0 = pos[UpgradeState.UPGRADE_REQUIRED]
    parts.append(
        f'<path d="M {hx + BOX_W / 2} {hy} C {hx + BOX_W / 2} '
        f'{uy0 + BOX_H + 60}, {ux0 + 30} {uy0 + BOX_H + 60}, '
        f'{ux0 + 40} {uy0 + BOX_H + 4}" '
        f'fill="none" stroke="{FAIL_EDGE}" stroke-width="1.2" '
        'stroke-dasharray="5,4" marker-end="url(#arr)"/>')

    # failure state + edges
    fx, fy = 30 + 2 * (BOX_W + COL_GAP), FAIL_Y
    parts.append(box(fx, fy, UpgradeState.FAILED, FAIL_FILL, FAIL_EDGE))
    parts.append(small_text(
        fx + BOX_W / 2, fy + BOX_H + 18,
        ["from any active state: cordon/drain/eviction failure,",
         "driver pod >10 restarts, validation timeout (600 s).",
         "Auto-recovers to uncordon-required once the pod is in sync+ready;",
         "a failed member holds its whole clique at the barriers."]))
    for s in (UpgradeState.DRAIN_REQUIRED, UpgradeState.POD_RESTART_REQUIRED,
              UpgradeState.VALIDATION_REQUIRED):
        sx, sy = pos[s]
        parts.append(
            f'<line x1="{sx + BOX_W / 2}" y1="{sy + BOX_H}" '
            f'x2="{fx + BOX_W / 2}" y2="{fy - 4}" stroke="{FAIL_EDGE}" '
            'stroke-width="1.2" stroke-dasharray="5,4" '
            'marker-end="url(#arr)"/>')
    # recovery edge
    ux, uy = pos[UpgradeState.UNCORDON_REQUIRED]
    parts.append(
        f'<path d="M {fx} {fy + BOX_H / 2} C {ux - 80} {fy + BOX_H / 2}, '
        f'{ux - 60} {uy + BOX_H + 40}, {ux + BOX_W / 3} {uy + BOX_H + 4}" '
        f'fill="none" stroke="{EDGE}" stroke-width="1.2" '
        'stroke-dasharray="5,4" marker-end="url(#arr)"/>')
    parts.append("</svg>")

    out = Path(out_path) if out_path else DEFAULT_OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(parts) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
