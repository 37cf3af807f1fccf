"""Axis pairs rendered on each detail page (reference plot_variants.py:4-8).

The port's copy of kmb_tpu/plotting/plot_variants.py.

Cross product of time/throughput axes with error axes, plus the
memory-footprint column — every pair is a (time-or-resource, accuracy)
trade-off whose Pareto front the website shows.
"""

all_plot_variants = {
    "total-time/rmse": ("total-time", "rmse-error"),
    "total-time/max-error": ("total-time", "max-error"),
    "total-time/mean-error": ("total-time", "mean-error"),
    "query-time/rmse": ("query-time", "rmse-error"),
    "query-time/max-error": ("query-time", "max-error"),
    "query-time/mean-error": ("query-time", "mean-error"),
    "memory-footprint/rmse": ("memory-footprint", "rmse-error"),
    "memory-footprint/max-error": ("memory-footprint", "max-error"),
    "memory-footprint/mean-error": ("memory-footprint", "mean-error"),
    "pairs-per-second/rmse": ("pairs-per-second", "rmse-error"),
    "scaling-efficiency/rmse": ("scaling-efficiency", "rmse-error"),
}
