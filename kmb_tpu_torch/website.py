"""Build the static benchmark website: index + detail pages.

The port's twin of the repository's create_website.py, as a module that
renders the repository's templates/:

    python -m kmb_tpu_torch.website --outputdir website

jinja2 (and matplotlib, for the summary PNGs) are imported only when a
site is rendered.  Rebuild of reference create_website.py:78-376: one
interactive detail page per dataset AND per algorithm (Chart.js log-log
plots of every plot variant, with Pareto fronts per series), optional
LaTeX/tikz export and scatter mode, a summary PNG per dataset via
plot.create_plot, and an index page linking everything.  Unlike the
reference, argparse runs under `__main__`/`main()` instead of at import
time (reference bug, create_website.py:93-119).
"""

from __future__ import annotations

import argparse
import hashlib
import os

from kmb_tpu_torch.datasets import get_dataset, get_dataset_fn
from kmb_tpu_torch.plotting.metrics import all_metrics
from kmb_tpu_torch.plotting.plot_variants import all_plot_variants
from kmb_tpu_torch.plotting.utils import (
    compute_all_metrics, create_linestyles, create_pointset, get_plot_label)
from kmb_tpu_torch.results import load_all_results

_TEMPLATE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "templates")


def _env():
    from jinja2 import Environment, FileSystemLoader

    return Environment(loader=FileSystemLoader(_TEMPLATE_DIR))


def _color_css(color):
    r, g, b, a = color
    return f"rgba({int(r * 255)},{int(g * 255)},{int(b * 255)},{a})"


def _chart_id(*parts):
    return hashlib.md5("|".join(parts).encode()).hexdigest()[:12]


def prepare_data(data, xn, yn):
    """[(algo, name, x, y)] rows for one page and one plot variant."""
    return [(algo, name, values[xn], values[yn])
            for algo, name, values in data
            if xn in values and yn in values]


def create_plot(env, data, xn, yn, linestyles, chart_id, latex=False,
                scatter=False):
    """Render one Chart.js plot (+ optional tikz export) to an HTML blob."""
    xm, ym = all_metrics[xn], all_metrics[yn]
    by_algo = {}
    for algo, name, x, y in data:
        by_algo.setdefault(algo, []).append((algo, name, x, y))

    runs = []
    for algo in sorted(by_algo):
        xs, ys, ls, axs, ays, als = create_pointset(by_algo[algo], xn, yn)
        if scatter:
            xs, ys, ls = axs, ays, als
        if not xs:
            continue
        runs.append({
            "algo": algo,
            "color": _color_css(linestyles[algo][0]),
            "points": [
                {"x": x, "y": y, "label": label}
                for x, y, label in zip(xs, ys, ls)],
        })
    if not runs:
        return None

    plot_label = get_plot_label(xm, ym)
    latex_code = None
    if latex:
        latex_code = env.get_template("latex.template").render(
            xlabel=xm["description"], ylabel=ym["description"],
            runs=runs, caption=plot_label, chart_id=chart_id)
    return env.get_template("chartjs.template").render(
        chart_id=chart_id, runs=runs, xlabel=xm["description"],
        ylabel=ym["description"], plot_label=plot_label,
        latex_code=latex_code, scatter=scatter)


def render_summary_png(name, runs, linestyles, outputdir):
    """Static matplotlib summary render next to the interactive plots.

    The reference embeds a plot.py PNG on every detail page
    (reference create_website.py:240-256); this renders the default
    plot.py variant (total-time vs rmse-error, log-log Pareto fronts)
    into the site directory and returns its page-relative filename.
    """
    from kmb_tpu_torch import plot as plot_module
    xn, yn = "total-time", "rmse-error"
    all_data = {}
    for algo, label, x, y in prepare_data(runs, xn, yn):
        all_data.setdefault(algo, []).append((algo, label, x, y))
    if not all_data:
        return None
    png = f"{name}_summary.png"
    plot_module.create_plot(all_data, False, "log", "log", xn, yn,
                            os.path.join(outputdir, png), linestyles)
    return png


def build_detail_site(env, data, label_fn, linestyles, outputdir, args,
                      descriptions=None, summary_png=False):
    """One page per entity (dataset or algorithm); returns index entries."""
    entries = []
    for name, runs in sorted(data.items()):
        title = label_fn(name)
        page = f"{name}.html"
        plots = []
        for variant_name, (xn, yn) in all_plot_variants.items():
            rows = prepare_data(runs, xn, yn)
            html = create_plot(
                env, rows, xn, yn, linestyles,
                _chart_id(name, variant_name),
                latex=args.latex, scatter=args.scatter)
            if html:
                plots.append(html)
        png = (render_summary_png(name, runs, linestyles, outputdir)
               if summary_png else None)
        rendered = env.get_template("detail_page.html").render(
            title=title, plots=plots, summary_png=png,
            description=(descriptions or {}).get(name, ""))
        with open(os.path.join(outputdir, page), "w") as f:
            f.write(rendered)
        entries.append({"name": name, "page": page, "n_runs": len(runs),
                        "summary_png": png})
    return entries


def load_results_grouped(datasets=None, recompute=False):
    """{by_dataset, by_algorithm} nested aggregation of all stored runs."""
    by_dataset, by_algorithm = {}, {}
    dataset_files = {}
    skipped_no_data = set()
    try:
        for properties, result_file in load_all_results():
            dataset_name = properties["dataset"]
            if datasets and dataset_name not in datasets:
                continue
            if dataset_name not in dataset_files:
                # Metrics need the dataset HDF5 open (attrs + shapes); a
                # missing data file would force regenerating ground truth
                # (hours at 2^20 scale), so skip the dataset — loudly, or
                # a results/ checkout without data/ looks like an almost
                # empty website for no visible reason.
                if not os.path.exists(get_dataset_fn(dataset_name)):
                    if dataset_name not in skipped_no_data:
                        skipped_no_data.add(dataset_name)
                        print(f"WARNING: skipping {dataset_name}: no data "
                              f"file at {get_dataset_fn(dataset_name)} "
                              "(run kmb_tpu_torch.create_dataset to include it)")
                    continue
                dataset_files[dataset_name] = get_dataset(dataset_name)[0]
            entry = compute_all_metrics(
                dataset_files[dataset_name], result_file, properties,
                recompute=recompute)
            by_dataset.setdefault(dataset_name, []).append(entry)
            by_algorithm.setdefault(properties["algo"], []).append(entry)
    finally:
        for f in dataset_files.values():
            f.close()
    return by_dataset, by_algorithm


def dataset_descriptions(names):
    out = {}
    for name in names:
        try:
            f, _ = get_dataset(name)
        except Exception:
            continue
        out[name] = str(f.attrs.get("description", ""))
        f.close()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m kmb_tpu_torch.website")
    parser.add_argument("--outputdir", default="website",
                        help="directory for the generated site")
    parser.add_argument("--latex", action="store_true",
                        help="include LaTeX (tikz) export blocks")
    parser.add_argument("--scatter", action="store_true",
                        help="plot raw points instead of Pareto fronts")
    parser.add_argument("--recompute", action="store_true",
                        help="recompute cached metrics in result files")
    parser.add_argument("--datasets", nargs="*",
                        help="restrict to these datasets")
    args = parser.parse_args(argv)

    os.makedirs(args.outputdir, exist_ok=True)
    env = _env()

    by_dataset, by_algorithm = load_results_grouped(
        datasets=args.datasets, recompute=args.recompute)
    linestyles = create_linestyles(
        sorted({algo for runs in by_dataset.values()
                for algo, _, _ in runs}))

    dataset_entries = build_detail_site(
        env, by_dataset, lambda name: f"Dataset: {name}", linestyles,
        args.outputdir, args, dataset_descriptions(by_dataset),
        summary_png=True)
    algorithm_entries = build_detail_site(
        env, by_algorithm, lambda name: f"Algorithm: {name}", linestyles,
        args.outputdir, args)

    # Enrich dataset index rows with task/kernel from the dataset attrs.
    for entry in dataset_entries:
        try:
            f, _ = get_dataset(entry["name"])
            entry["task"] = str(f.attrs.get("task", "?"))
            entry["kernel"] = str(f.attrs.get("kernel", "?"))
            f.close()
        except Exception:
            entry["task"] = entry["kernel"] = "?"
    for entry in algorithm_entries:
        entry["n_datasets"] = sum(
            1 for runs in by_dataset.values()
            if any(run[0] == entry["name"] for run in runs))

    index = env.get_template("summary.html").render(
        title="Index", datasets=dataset_entries,
        algorithms=algorithm_entries)
    with open(os.path.join(args.outputdir, "index.html"), "w") as f:
        f.write(index)
    print(f"Wrote website to {args.outputdir}/ "
          f"({len(dataset_entries)} datasets, "
          f"{len(algorithm_entries)} algorithms)")


if __name__ == "__main__":
    main()
