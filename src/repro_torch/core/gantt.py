"""Gantt-chart export (paper §3.1, Fig. 3).

Consumes either the Python oracle's interval list or the PyTorch engine's
:class:`GanttLog` snapshots, producing a per-node interval table, a CSV file,
and (when matplotlib is available) a PNG with the paper's color scheme:
light blue = idle, dark blue = sleeping, red = switching off,
green = switching on, colored blocks = jobs, black = terminated jobs.
"""
from __future__ import annotations

import csv
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import ACTIVE, IDLE, SLEEP, STATE_NAMES, SWITCHING_OFF, SWITCHING_ON

Interval = Tuple[float, float, int, int, int]  # t0, t1, node, state, job


def _host(x) -> np.ndarray:
    """numpy view of a log member (torch tensors may live on the card)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def intervals_from_log(log) -> List[Interval]:
    """Convert an engine GanttLog (per-batch snapshots) into merged intervals."""
    n = int(log.n)
    t0 = _host(log.t0)[:n]
    t1 = _host(log.t1)[:n]
    state = _host(log.state)[:n]
    job = _host(log.job)[:n]
    out: List[Interval] = []
    n_nodes = state.shape[1] if n else 0
    for nid in range(n_nodes):
        cur: Optional[List] = None
        for i in range(n):
            s, j = int(state[i, nid]), int(job[i, nid])
            if cur is not None and cur[3] == s and cur[4] == j and cur[1] == t0[i]:
                cur[1] = t1[i]
            else:
                if cur is not None and cur[1] > cur[0]:
                    out.append(tuple(cur))
                cur = [float(t0[i]), float(t1[i]), nid, s, j]
        if cur is not None and cur[1] > cur[0]:
            out.append(tuple(cur))
    return out


def write_csv(intervals: Sequence[Interval], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["t0", "t1", "node", "state", "state_name", "job"])
        for t0, t1, nid, st, job in sorted(intervals, key=lambda r: (r[2], r[0])):
            w.writerow([t0, t1, nid, st, STATE_NAMES[st], job])


def render_png(
    intervals: Sequence[Interval],
    path: str,
    terminated_jobs: Sequence[int] = (),
    title: str = "SPARS-X Gantt",
) -> bool:
    """Render the paper's Fig.-3-style Gantt. Returns False if matplotlib
    is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Patch
    except ImportError:  # pragma: no cover
        return False

    term = set(int(j) for j in terminated_jobs)
    state_colors = {
        IDLE: "#add8e6",  # light blue
        SLEEP: "#00008b",  # dark blue
        SWITCHING_ON: "#2e8b57",  # green
        SWITCHING_OFF: "#cc2222",  # red
    }
    cmap = [
        "#e6994c", "#8cc04c", "#4cc0a8", "#4c8cc0", "#a84cc0",
        "#c04c6e", "#c0b24c", "#6ec04c", "#4cc0c0", "#7a4cc0",
    ]
    nodes = sorted({r[2] for r in intervals})
    fig, ax = plt.subplots(figsize=(14, max(3, 0.35 * len(nodes) + 1)))
    labeled = set()
    for t0, t1, nid, st, job in intervals:
        if st == ACTIVE:
            color = "black" if job in term else cmap[job % len(cmap)]
        else:
            color = state_colors.get(st, "#dddddd")
        ax.barh(nid, t1 - t0, left=t0, height=0.9, color=color, linewidth=0)
        if st == ACTIVE and job not in labeled and job not in term and t1 - t0 > 0:
            ax.text((t0 + t1) / 2, nid, str(job), ha="center", va="center", fontsize=6)
            labeled.add(job)
    ax.set_xlabel("simulation time (s)")
    ax.set_ylabel("compute node")
    ax.set_title(title)
    ax.legend(
        handles=[
            Patch(color="#add8e6", label="idle"),
            Patch(color="#00008b", label="sleeping"),
            Patch(color="#2e8b57", label="switching on"),
            Patch(color="#cc2222", label="switching off"),
            Patch(color="black", label="terminated job"),
        ],
        loc="upper right",
        fontsize=7,
    )
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return True
