"""Render one (x, y) metric trade-off plot with Pareto fronts to PNG.

The port's twin of the repository's plot.py, as a module:

    python -m kmb_tpu_torch.plot --dataset NAME [-x METRIC] [-y METRIC]

Rebuild of reference plot.py:26-193: log/log axes by default, Pareto front
per algorithm with optional faded raw points, legend placed in the corner
the fronts vacate, output to `results/{dataset}.png`.  matplotlib is
imported only when a plot is drawn.  A missing dataset file is generated
with its truth computed on the card, or on the CPU with `--hardware CPU`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from kmb_tpu_torch.datasets import DATASETS, get_dataset
from kmb_tpu_torch.plotting.metrics import all_metrics
from kmb_tpu_torch.plotting.utils import (
    compute_metrics, create_linestyles, create_pointset, get_plot_label)
from kmb_tpu_torch.results import get_unique_algorithms, load_all_results


def create_plot(all_data, raw, x_scale, y_scale, xn, yn, fn_out,
                linestyles):
    import matplotlib
    matplotlib.use("Agg")  # headless
    import matplotlib.pyplot as plt

    xm, ym = all_metrics[xn], all_metrics[yn]
    plt.figure(figsize=(12, 9))

    # Sort runs so that adjacent labels in the legend correspond to
    # adjacent curves (mean log-y ordering, reference plot.py:39-43).
    def mean_log_y(algo):
        ys = [t[-1] for t in all_data[algo] if t[-1] > 0]
        return -np.log(np.array(ys)).mean() if ys else 0.0

    handles, labels = [], []
    min_x, max_x = float("inf"), float("-inf")
    for algo in sorted(all_data.keys(), key=mean_log_y):
        xs, ys, ls, axs, ays, als = create_pointset(all_data[algo], xn, yn)
        if not xs:
            continue
        min_x = min([min_x] + [x for x in xs if x > 0])
        max_x = max([max_x] + [x for x in xs if x < float("inf")])
        color, faded, linestyle, marker = linestyles[algo]
        (handle,) = plt.plot(
            xs, ys, "-", label=algo, color=color, ms=7, mew=3, lw=3,
            marker=marker)
        handles.append(handle)
        if raw:
            (handle2,) = plt.plot(
                axs, ays, "-", label=algo, color=faded, ms=5, mew=2, lw=2,
                marker=marker)
        labels.append(algo)

    ax = plt.gca()
    ax.set_ylabel(ym["description"])
    ax.set_xlabel(xm["description"])
    # Legend in the "least important" corner: the Pareto fronts crowd the
    # best corner, so anchor the legend box to the opposite one.
    ax.legend(
        handles, labels, loc="center left", bbox_to_anchor=(1, 0.5),
        prop={"size": 9})
    plt.grid(visible=True, which="major", color="0.65", linestyle="-")
    plt.grid(visible=True, which="minor", color="0.85", linestyle="-")
    plt.setp(ax.get_xminorticklabels(), visible=True)

    if x_scale[0] == "a":
        alpha = float(x_scale[1:])
        def fun(x):
            return 1 - (1 - x) ** (1 / alpha)
        def inv_fun(x):
            return 1 - (1 - x) ** alpha
        ax.set_xscale("function", functions=(fun, inv_fun))
        if alpha <= 3:
            ticks = [inv_fun(x) for x in np.arange(0, 1.2, 0.2)]
            plt.xticks(ticks)
    else:
        ax.set_xscale(x_scale)
    ax.set_yscale(y_scale)
    ax.set_title(get_plot_label(xm, ym))
    plt.gca().get_position()
    plt.savefig(fn_out, bbox_inches="tight")
    plt.close()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m kmb_tpu_torch.plot")
    parser.add_argument("--dataset", metavar="DATASET", required=True,
                        choices=DATASETS.keys())
    parser.add_argument(
        "--hardware", default="GPU", choices=["CPU", "GPU"],
        help="where a missing dataset's float64 truth is computed")
    parser.add_argument("--output")
    parser.add_argument(
        "-x", "--x-axis", metavar="X", default="total-time",
        choices=all_metrics.keys(),
        help="which metric to use on the X-axis")
    parser.add_argument(
        "-y", "--y-axis", metavar="Y", default="rmse-error",
        choices=all_metrics.keys(),
        help="which metric to use on the Y-axis")
    parser.add_argument(
        "-X", "--x-scale", default="log",
        help="x-axis scale: linear | log | symlog | logit | a{power}")
    parser.add_argument(
        "-Y", "--y-scale", default="log",
        choices=["linear", "log", "symlog", "logit"])
    parser.add_argument(
        "--raw", action="store_true",
        help="also show faded non-Pareto points")
    parser.add_argument(
        "--recompute", action="store_true",
        help="clear the cached metrics inside result files")
    args = parser.parse_args(argv)

    output = args.output or os.path.join("results", f"{args.dataset}.png")
    os.makedirs(os.path.dirname(output), exist_ok=True)

    dataset, _ = get_dataset(
        args.dataset, device="cuda" if args.hardware == "GPU" else "cpu")
    unique_algorithms = get_unique_algorithms(args.dataset)
    results = load_all_results(args.dataset)
    linestyles = create_linestyles(sorted(unique_algorithms))
    runs = compute_metrics(
        dataset, results, args.x_axis, args.y_axis, args.recompute)
    dataset.close()
    if not runs:
        raise Exception("Nothing to plot")

    create_plot(
        runs, args.raw, args.x_scale, args.y_scale, args.x_axis,
        args.y_axis, output, linestyles)
    print(f"Wrote {output}")


if __name__ == "__main__":
    main()
