"""Tabulation and plotting (parity with the reference ``visualise.py``
modules and Evolve's DeviationPlotter).

``tabulator`` builds a per-iteration table (a list of row dicts) of
residual norms and invariant deviations per solver (reference
lkdv/visualise.py:13-59), optionally writing ``.tex``/``.csv``;
``markdown_table`` formats such rows for the terminal; ``convergence_plot``
renders the log-scale comparison figure (lkdv/visualise.py:63-112);
``deviation_plot`` renders invariant drift over a time evolution
(lkdv/Evolve.py:70-114).  Only the plots need matplotlib, imported when
called.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Sequence

import numpy as np


def _deviations(system, xs):
    """Per-iterate invariant deviations.  xs[0] is the initial residual
    vector (reference quirk) — iterate from index 1
    (lkdv/visualise.py:28)."""
    import jax.numpy as jnp

    names = None
    rows = []
    for j in range(1, len(xs)):
        inv = system.compute_invariants(jnp.asarray(xs[j]))
        if names is None:
            names = list(inv.keys())
        targets = _targets(system, names)
        rows.append([float(inv[k]) - targets[k] for k in names])
    return names or [], np.asarray(rows)


def _targets(system, names):
    out = {}
    for k in names:
        attr = {"mass": "m0", "momentum": "mo0", "energy": "e0"}[k]
        out[k] = float(getattr(system, attr))
    return out


def _fmt(v, floatfmt: str) -> str:
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return format(float(v), floatfmt)
    return str(v)


def _columns(rows: Sequence[dict]) -> List[str]:
    cols: List[str] = []
    for r in rows:
        cols.extend(c for c in r if c not in cols)
    return cols


def markdown_table(rows: Sequence[dict], floatfmt: str = ".2e") -> str:
    """GitHub-markdown table of ``rows`` (one dict per row; columns in
    first-seen order, a missing cell left blank, floats as ``floatfmt``)."""
    cols = _columns(rows)
    cells = [[_fmt(r.get(c), floatfmt) for c in cols] for r in rows]
    widths = [max([len(c)] + [len(row[i]) for row in cells])
              for i, c in enumerate(cols)]

    def line(vals):
        return "| " + " | ".join(
            v.ljust(w) for v, w in zip(vals, widths)) + " |"

    out = [line(cols), "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
    out += [line(row) for row in cells]
    return "\n".join(out)


def tabulator(system, dict_list: List[dict], filename: Optional[str] = None,
              print_table: bool = False):
    """Per-iteration table of residuals + invariant deviations for each
    solver run: ``{"rows": [...], "columns": [...], "names": [...]}``, row
    ``i`` holding iteration ``i`` of every series long enough to have one.

    Each entry of ``dict_list`` is a solver info dict with history
    (``history=True`` runs)."""
    series = {}
    names = []
    for data in dict_list:
        name = data["name"]
        names.append(name)
        series[f"{name} residual norm"] = [float(v) for v in data["res"]]
        inv_names, devs = _deviations(system, data["x"])
        for i, inv in enumerate(inv_names):
            series[f"{name} {inv} deviation"] = [float(v) for v in devs[:, i]]
    columns = list(series)
    length = max((len(v) for v in series.values()), default=0)
    rows = [{c: series[c][i] for c in columns if i < len(series[c])}
            for i in range(length)]
    if filename is not None:
        with open(filename + ".csv", "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=columns)
            writer.writeheader()
            writer.writerows(rows)
        with open(filename + ".tex", "w") as fh:
            fh.write("\\begin{tabular}{" + "r" * len(columns) + "}\n")
            fh.write(" & ".join(columns) + " \\\\\n\\hline\n")
            for r in rows:
                fh.write(" & ".join(_fmt(r.get(c), ".6e") for c in columns)
                         + " \\\\\n")
            fh.write("\\end{tabular}\n")
    if print_table:
        print(markdown_table(rows, floatfmt=".6e"))
    return {"rows": rows, "columns": columns, "names": names}


def _ensure_plots_dir(path: Optional[str]) -> str:
    d = path or os.path.join(os.getcwd(), "plots")
    os.makedirs(d, exist_ok=True)
    return d


def convergence_plot(vis_out, filename: Optional[str] = None, title: str = ""):
    """Log-scale residual + deviation comparison across solvers."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = vis_out["rows"]
    names = vis_out["names"]

    def column(col):
        return np.asarray([r[col] for r in rows if col in r])

    colors = ["r", "b", "k", "g"]
    fig, ax = plt.subplots(figsize=(7, 5))
    for name, c in zip(names, colors):
        ax.plot(column(f"{name} residual norm"), c + "-", lw=2,
                label=f"{name}: residual")
        styles = iter([":", "-.", "--", "-"])
        for col in vis_out["columns"]:
            if col.startswith(name) and col.endswith("deviation"):
                ax.plot(np.abs(column(col)) + 1e-16, c + next(styles), lw=2,
                        label=f"{name}: {col.split(' ', 1)[1]}")
    ax.set_yscale("log")
    ax.set_xlabel("Iteration number")
    ax.grid(which="both", linestyle="--", axis="y")
    ax.legend(loc="best", ncol=2, fontsize="small")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    out = filename or os.path.join(_ensure_plots_dir(None), "convergence.pdf")
    fig.savefig(out)
    plt.close(fig)
    print(f"Figure saved as {out}")
    return out


def deviation_plot(runs: dict, filename: Optional[str] = None):
    """Invariant drift over time for multiple evolve runs
    (reference DeviationPlotter, lkdv/Evolve.py:70-114).

    ``runs`` maps a label (e.g. 'GMRES'/'CGMRES') to an evolve output dict
    with keys ``time`` and per-invariant drift arrays (``dm``/``dmo``/``de``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    styles = {"dm": ("dotted", "Mass"), "dmo": ("dashdot", "Momentum"),
              "de": ("dashed", "Energy")}
    colors = ["r", "b", "k", "g"]
    fig, ax = plt.subplots(figsize=(7, 5))
    for (label, out), c in zip(runs.items(), colors):
        for key, (ls, inv) in styles.items():
            if key in out and len(out[key]):
                ax.semilogy(out["time"], np.maximum(out[key], 1e-18),
                            color=c, linestyle=ls, lw=2,
                            label=f"{label}: {inv} deviation")
    ax.grid(which="major", linestyle="--", axis="y")
    ax.set_xlabel("t")
    ax.legend(loc="best", ncol=2, fontsize="small")
    fig.tight_layout()
    out_path = filename or os.path.join(_ensure_plots_dir(None), "evolve.pdf")
    fig.savefig(out_path)
    plt.close(fig)
    print(f"Figure saved as {out_path}")
    return out_path
