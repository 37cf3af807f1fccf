"""Tabular report of stored benchmark results (Markdown or TSV).

The port's twin of the repository's report.py, as a module.  Companion to
kmb_tpu_torch.plot / kmb_tpu_torch.website for quick inspection and for
committing compact, human-auditable snapshots of large-scale runs:

    python -m kmb_tpu_torch.report        # every dataset, Markdown
    python -m kmb_tpu_torch.report --dataset 'product-cube-*M1048576*'
    python -m kmb_tpu_torch.report --format tsv > results.tsv

Columns: dataset, algorithm, parameter string, build/query time, RMSE
and max error vs the float64 ground truth (computed through the same
metrics cache as plot.py — reference plotting/metrics.py:36-61), plus
any cg_iterations / compression extras the algorithm recorded via
get_additional (reference base.py:44).
"""

from __future__ import annotations

import argparse
import fnmatch
import os

from kmb_tpu_torch.plotting.metrics import get_error_statistics
from kmb_tpu_torch.plotting.utils import get_or_create_metrics
from kmb_tpu_torch.results import load_all_results

EXTRA_KEYS = ("cg_iterations", "cg_relative_residual", "compression",
              "mean_block_rank", "n_chips")


def collect(dataset_glob):
    rows = []
    for props, f in load_all_results():
        if not fnmatch.fnmatch(props["dataset"], dataset_glob):
            continue
        stats = get_error_statistics(f, get_or_create_metrics(f))
        extras = {k: props[k] for k in EXTRA_KEYS if k in props}
        rows.append({
            "dataset": props["dataset"],
            "algorithm": props["algo"],
            "name": props.get("name", ""),
            "build_s": float(props["build_time"]),
            "query_s": float(props["query_time"]),
            "rmse": float(stats["rmse"]),
            "max_err": float(stats["max"]),
            "extras": " ".join(f"{k}={extras[k]}" for k in sorted(extras)),
        })
    rows.sort(key=lambda r: (r["dataset"], r["query_s"] + r["build_s"]))
    return rows


def emit(rows, fmt):
    cols = ["dataset", "algorithm", "name", "build_s", "query_s",
            "rmse", "max_err", "extras"]
    if fmt == "tsv":
        print("\t".join(cols))
        for r in rows:
            print("\t".join(_fmt(r[c]) for c in cols))
        return
    last = None
    for r in rows:
        if r["dataset"] != last:
            last = r["dataset"]
            print(f"\n### {last}\n")
            print("| algorithm | parameters | build (s) | query (s) "
                  "| RMSE | max err | extras |")
            print("|---|---|---|---|---|---|---|")
        print(f"| {r['algorithm']} | {r['name']} | {_fmt(r['build_s'])} "
              f"| {_fmt(r['query_s'])} | {_fmt(r['rmse'])} "
              f"| {_fmt(r['max_err'])} | {r['extras']} |")


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m kmb_tpu_torch.report",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", default="*",
                        help="fnmatch glob over dataset names")
    parser.add_argument("--format", choices=("markdown", "tsv"),
                        default="markdown")
    args = parser.parse_args(argv)
    rows = collect(args.dataset)
    if not rows:
        raise SystemExit(f"No results match {args.dataset!r} under "
                         f"{os.path.abspath('results')}.")
    emit(rows, args.format)


if __name__ == "__main__":
    main()
