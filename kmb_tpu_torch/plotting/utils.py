"""Metric computation, Pareto-front extraction, plot styling.

The port's copy of kmb_tpu/plotting/utils.py.
Rebuild of reference plotting/utils.py:8-289: apply metric functions to
stored runs (caching statistics inside the result HDF5), sweep out the
Pareto front of (x, y) trade-offs honoring each metric's optimization
direction, and generate deterministic colors/linestyles per algorithm.
"""

from __future__ import annotations

import colorsys
import math

from kmb_tpu_torch.plotting.metrics import all_metrics


def get_or_create_metrics(result_file):
    """The `metrics` cache group inside a result HDF5 file."""
    if "metrics" not in result_file:
        result_file.create_group("metrics")
    return result_file["metrics"]


def create_pointset(data, xn, yn):
    """Extract the Pareto front from (algo, name, x, y) tuples.

    `data` is a list of runs for ONE algorithm.  Sort by (y, x) in the
    "best first" direction given by the sign of each metric's `worst`
    (reference utils.py:38-42), then sweep keeping only points that improve
    x — the survivors are the front.  Returns (front, all) where each is
    (xs, ys, labels).
    """
    xm, ym = all_metrics[xn], all_metrics[yn]
    # Drop only missing/non-finite values — NOT zeros (the reference's
    # falsy check, utils.py:43, would silently drop a 0.0 build time or
    # an exactly-zero error statistic from the plots).
    data = [t for t in data
            if t[-1] is not None and t[-2] is not None
            and math.isfinite(t[-1]) and math.isfinite(t[-2])]
    rev_y = -1 if ym["worst"] < 0 else 1
    rev_x = -1 if xm["worst"] < 0 else 1
    data = sorted(data, key=lambda t: (rev_y * t[-1], rev_x * t[-2]))

    axs, ays, als = [], [], []
    xs, ys, ls = [], [], []
    last_x = xm["worst"]
    comparator = (
        (lambda xv, lx: xv > lx) if last_x < 0 else (lambda xv, lx: xv < lx))
    for algo, algo_name, xv, yv in data:
        axs.append(xv)
        ays.append(yv)
        als.append(algo_name)
        if comparator(xv, last_x):
            last_x = xv
            xs.append(xv)
            ys.append(yv)
            ls.append(algo_name)
    return xs, ys, ls, axs, ays, als


def compute_metrics(dataset, results, x_name, y_name, recompute=False):
    """Per-algorithm lists of (algo, run_name, x_value, y_value)."""
    all_results = {}
    for i, (properties, result_file) in enumerate(results):
        algo = properties["algo"]
        algo_name = properties["name"]
        if recompute and "metrics" in result_file:
            del result_file["metrics"]
        cache = get_or_create_metrics(result_file)
        x = all_metrics[x_name]["function"](
            dataset, result_file, properties, cache)
        y = all_metrics[y_name]["function"](
            dataset, result_file, properties, cache)
        all_results.setdefault(algo, []).append((algo, algo_name, x, y))
    return all_results


def compute_all_metrics(dataset, result_file, properties, recompute=False):
    """(algo, name, {metric: value}) for one stored run — website path."""
    algo = properties["algo"]
    algo_name = properties["name"]
    if recompute and "metrics" in result_file:
        del result_file["metrics"]
    cache = get_or_create_metrics(result_file)
    results = {}
    for name, metric in all_metrics.items():
        try:
            results[name] = metric["function"](
                dataset, result_file, properties, cache)
        except KeyError:
            continue  # run lacks an attribute this metric needs
    return algo, algo_name, results


_GOLDEN_RATIO_CONJUGATE = 0.6180339887498949


def generate_n_colors(n):
    """n distinct RGBA colors: golden-angle hue walk in HLS space.

    Successive hues step by the golden-ratio conjugate (maximally
    low-discrepancy on the hue circle), while lightness and saturation
    cycle through a small set of bands so neighbours in enumeration
    order also differ in tone, not just hue.
    """
    lightness_bands = (0.45, 0.65, 0.35, 0.55)
    saturation_bands = (0.80, 0.60)
    hue = 0.11  # start in the orange range rather than pure red
    colors = []
    for i in range(n):
        hue = (hue + _GOLDEN_RATIO_CONJUGATE) % 1.0
        light = lightness_bands[i % len(lightness_bands)]
        sat = saturation_bands[(i // len(lightness_bands))
                               % len(saturation_bands)]
        colors.append(colorsys.hls_to_rgb(hue, light, sat) + (1.0,))
    return colors


_LINESTYLE_CYCLE = ("-", ":", "--", "-.")
_MARKER_CYCLE = ("o", "s", "^", "D", "v", "x")


def create_linestyles(unique_algorithms):
    """{algo: (color, faded_color, linestyle, marker)} deterministic map."""
    palette = generate_n_colors(len(unique_algorithms))
    styles = {}
    for i, algo in enumerate(unique_algorithms):
        r, g, b, _ = palette[i]
        styles[algo] = (
            palette[i],
            (r, g, b, 0.3),
            _LINESTYLE_CYCLE[i % len(_LINESTYLE_CYCLE)],
            _MARKER_CYCLE[i % len(_MARKER_CYCLE)],
        )
    return styles


def get_up_down(metric):
    return "down" if metric["worst"] == float("inf") else "up"


def get_left_right(metric):
    return "left" if metric["worst"] == float("inf") else "right"


def get_plot_label(xm, ym):
    template = (
        "%(xlabel)s-%(ylabel)s tradeoff — %(updown)s and"
        " to the %(leftright)s is better")
    return template % {
        "xlabel": xm["description"],
        "ylabel": ym["description"],
        "updown": get_up_down(ym),
        "leftright": get_left_right(xm),
    }
