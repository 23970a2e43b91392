"""Statistical comparison of measurement-result CSVs
(Partsize-identical/visualization_results/result/evaluation.py):
per-dimension metrics (:80-91), comparison tables (:92-108), Bland-Altman
plots (:114-267), error distributions (:268-370), per-component/per-case
error charts (:371-559), regression analysis (:560-628).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def dimension_metrics(measured: np.ndarray, truth: np.ndarray) -> Dict[str, float]:
    """MAE / RMSE / MAPE / bias / Pearson r (evaluation.py:80-91)."""
    measured = np.asarray(measured, float)
    truth = np.asarray(truth, float)
    err = measured - truth
    rel = err / np.where(truth != 0, truth, 1.0)
    r = float(np.corrcoef(measured, truth)[0, 1]) if len(truth) > 1 else float("nan")
    return {
        "MAE": float(np.mean(np.abs(err))),
        "RMSE": float(np.sqrt(np.mean(err**2))),
        "MAPE": float(np.mean(np.abs(rel)) * 100),
        "bias": float(np.mean(err)),
        "pearson_r": r,
        "n": int(len(truth)),
    }


def comparison_table(
    results: Dict[str, Dict[str, np.ndarray]]
) -> List[Dict[str, object]]:
    """Rows of per-method/per-dimension metrics. results[method] =
    {'measured': ..., 'truth': ...} or {'length': (m, t), 'width': (m, t)}."""
    rows = []
    for method, data in results.items():
        if "measured" in data:
            row = {"method": method, **dimension_metrics(data["measured"], data["truth"])}
            rows.append(row)
        else:
            for dim, (m, t) in data.items():
                rows.append({"method": method, "dimension": dim,
                             **dimension_metrics(m, t)})
    return rows


def bland_altman(
    measured: np.ndarray, truth: np.ndarray, out_path: Optional[str] = None,
    title: str = "Bland-Altman",
) -> Dict[str, float]:
    """Bland-Altman stats (mean diff, ±1.96 SD limits) + optional plot
    (evaluation.py:114-267)."""
    measured = np.asarray(measured, float)
    truth = np.asarray(truth, float)
    mean = (measured + truth) / 2
    diff = measured - truth
    md = float(np.mean(diff))
    sd = float(np.std(diff, ddof=1)) if len(diff) > 1 else 0.0
    stats = {
        "mean_diff": md,
        "sd_diff": sd,
        "loa_upper": md + 1.96 * sd,
        "loa_lower": md - 1.96 * sd,
        "within_loa_frac": float(
            np.mean(np.abs(diff - md) <= 1.96 * sd) if sd > 0 else 1.0
        ),
    }
    if out_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        ax.scatter(mean, diff, s=18, alpha=0.7)
        ax.axhline(md, color="tab:blue", label=f"mean {md:.3f}")
        ax.axhline(stats["loa_upper"], color="tab:red", ls="--",
                   label=f"+1.96 SD {stats['loa_upper']:.3f}")
        ax.axhline(stats["loa_lower"], color="tab:red", ls="--",
                   label=f"-1.96 SD {stats['loa_lower']:.3f}")
        ax.set_xlabel("mean of measurement and truth (m)")
        ax.set_ylabel("difference (m)")
        ax.set_title(title)
        ax.legend()
        fig.tight_layout()
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        fig.savefig(out_path, dpi=200)
        plt.close(fig)
    return stats


def error_distribution(
    errors: np.ndarray, out_path: Optional[str] = None, bins: int = 20,
    title: str = "Error distribution",
) -> Dict[str, float]:
    """Histogram + summary stats (evaluation.py:268-370)."""
    errors = np.asarray(errors, float)
    stats = {
        "mean": float(errors.mean()),
        "std": float(errors.std(ddof=1)) if len(errors) > 1 else 0.0,
        "median": float(np.median(errors)),
        "p90": float(np.percentile(errors, 90)),
        "max": float(errors.max()),
    }
    if out_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        ax.hist(errors, bins=bins, alpha=0.8)
        ax.axvline(stats["mean"], color="tab:red", label=f"mean {stats['mean']:.4f}")
        ax.set_title(title)
        ax.legend()
        fig.tight_layout()
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        fig.savefig(out_path, dpi=200)
        plt.close(fig)
    return stats


def regression_analysis(
    measured: np.ndarray, truth: np.ndarray, out_path: Optional[str] = None,
    title: str = "Regression",
) -> Dict[str, float]:
    """Least-squares fit measured ~ truth with R^2 (evaluation.py:560-628)."""
    measured = np.asarray(measured, float)
    truth = np.asarray(truth, float)
    slope, intercept = np.polyfit(truth, measured, 1)
    pred = slope * truth + intercept
    ss_res = float(np.sum((measured - pred) ** 2))
    ss_tot = float(np.sum((measured - measured.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else float("nan")
    stats = {"slope": float(slope), "intercept": float(intercept), "r2": r2}
    if out_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(truth, measured, s=18, alpha=0.7)
        xs = np.linspace(truth.min(), truth.max(), 50)
        ax.plot(xs, slope * xs + intercept, "r-",
                label=f"y={slope:.3f}x+{intercept:.3f} (R2={r2:.3f})")
        ax.plot(xs, xs, "k--", alpha=0.4, label="y=x")
        ax.set_xlabel("ground truth (m)")
        ax.set_ylabel("measured (m)")
        ax.set_title(title)
        ax.legend()
        fig.tight_layout()
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        fig.savefig(out_path, dpi=200)
        plt.close(fig)
    return stats


def _relative_error_pct(true_v: np.ndarray, pred_v: np.ndarray) -> np.ndarray:
    true_v = np.asarray(true_v, float)
    pred_v = np.asarray(pred_v, float)
    return np.abs(pred_v - true_v) / np.where(true_v != 0, true_v, 1.0) * 100


def _records_errors(records: Sequence[Dict], key: str, dimension: str):
    """Group relative errors (%) by `key` over measurement records
    ({'case', 'component', 'true_<dim>', 'pred_<dim>'})."""
    groups: Dict[str, List[float]] = {}
    tk, pk = f"true_{dimension}", f"pred_{dimension}"
    for r in records:
        if tk not in r or pk not in r:
            continue
        err = float(_relative_error_pct(np.array([r[tk]]), np.array([r[pk]]))[0])
        groups.setdefault(str(r.get(key, "?")), []).append(err)
    return groups


def plot_component_relative_errors(
    records1: Sequence[Dict],
    records2: Sequence[Dict],
    dimension: str = "length",
    save_path: Optional[str] = None,
    labels: Sequence[str] = ("Dataset 1", "Dataset 2"),
):
    """Per-component mean relative-error bars for two result sets, with
    dashed per-dataset mean lines (evaluation.py:371-467)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g1 = _records_errors(records1, "component", dimension)
    g2 = _records_errors(records2, "component", dimension)
    components = sorted(set(g1) | set(g2))
    e1 = [float(np.mean(g1.get(c, [np.nan]))) for c in components]
    e2 = [float(np.mean(g2.get(c, [np.nan]))) for c in components]

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.grid(True, linestyle="-.", linewidth=0.5, color="gray", alpha=0.5)
    x = np.arange(len(components))
    width = 0.35
    b1 = ax.bar(x - width / 2, e1, width, label=labels[0], color="#8dd3c7",
                edgecolor="black", linewidth=0.75)
    b2 = ax.bar(x + width / 2, e2, width, label=labels[1], color="#bebada",
                edgecolor="black", linewidth=0.75)
    ax.bar_label(b1, fmt="%.1f", fontsize=9)
    ax.bar_label(b2, fmt="%.1f", fontsize=9)
    ax.axhline(np.nanmean(e1), color="#5bb3a7", linestyle="--", linewidth=1.5)
    ax.axhline(np.nanmean(e2), color="#9281c9", linestyle="--", linewidth=1.5)
    ax.set_xticks(x, components)
    ax.set_ylabel("Relative Error (%)")
    ax.set_title(f"{dimension.capitalize()} Errors by Component")
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
        fig.savefig(os.path.splitext(save_path)[0] + ".pdf", format="pdf",
                    bbox_inches="tight")
    return fig


def plot_case_errors(
    records1: Sequence[Dict],
    records2: Sequence[Dict],
    dimension: str = "length",
    save_path: Optional[str] = None,
    labels: Sequence[str] = ("Dataset 1", "Dataset 2"),
):
    """Per-case relative-error boxplots for two result sets side by side
    with a dataset separator (evaluation.py:470-556)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g1 = _records_errors(records1, "case", dimension)
    g2 = _records_errors(records2, "case", dimension)
    cases1, cases2 = sorted(g1), sorted(g2)
    data1 = [g1[c] for c in cases1]
    data2 = [g2[c] for c in cases2]

    fig, ax = plt.subplots(figsize=(10, 6))
    ax.grid(True, linestyle="-.", linewidth=0.5, color="gray", alpha=0.5)
    positions = np.arange(1, len(cases1) + len(cases2) + 1)
    if data1:
        ax.boxplot(
            data1, positions=positions[: len(cases1)], patch_artist=True,
            boxprops=dict(facecolor="lightblue", color="blue"),
            medianprops=dict(color="blue"), whiskerprops=dict(color="blue"),
            capprops=dict(color="blue"),
            flierprops=dict(color="blue", markeredgecolor="blue"),
        )
    if data2:
        ax.boxplot(
            data2, positions=positions[len(cases1):], patch_artist=True,
            boxprops=dict(facecolor="lightgreen", color="green"),
            medianprops=dict(color="green"), whiskerprops=dict(color="green"),
            capprops=dict(color="green"),
            flierprops=dict(color="green", markeredgecolor="green"),
        )
    ax.set_xticks(positions)
    ax.set_xticklabels(cases1 + cases2)
    ax.set_ylabel("Relative Error (%)")
    ax.set_xlabel("Case")
    ax.set_title(f"{dimension.capitalize()} Errors by Case")
    if cases1 and cases2:
        ax.axvline(x=len(cases1) + 0.5, color="gray", linestyle="--", alpha=0.5)
    ax.plot([], [], marker="s", markerfacecolor="lightblue", color="black",
            linestyle="", markersize=10, label=labels[0])
    ax.plot([], [], marker="s", markerfacecolor="lightgreen", color="black",
            linestyle="", markersize=10, label=labels[1])
    ax.legend(loc="upper left", frameon=True, edgecolor="black")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
        fig.savefig(os.path.splitext(save_path)[0] + ".pdf", format="pdf",
                    bbox_inches="tight")
    return fig
