"""The least time an NVIDIA H100 could take for a kernel-matrix product.

A frozen copy of the peaks and of `bound_ms` as the port's smoke script
had them: later changes to the program cannot move this yardstick.

Peaks: H100 SXM data sheet, dense rates, at the 700 W limit.  The
special-function units' rate comes from the card itself: 16 operations per
clock per SM, at the SM count torch reports and the maximum SM clock
nvidia-smi reports.
"""

from __future__ import annotations

import subprocess

PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK_PER_SM = 16

# The large-D form product and a wide signal product on the tensor cores:
# (passes, peak) per tier.  The float32 tiers run 3xTF32, bfloat16 one pass.
TENSOR_CORE_FORM = {"float32": (3, PEAK_TF32_FLOPS),
                    "float32x3": (3, PEAK_TF32_FLOPS),
                    "bfloat16": (1, PEAK_BF16_FLOPS)}


def bound_ms(n, m, d, e, which, normalize, tier, sfu_rate):
    """(least ms, "operations" or "bytes", the unit that bounds it) of one
    product of n targets by m sources in D dimensions with E signal columns.

    The larger of each unit's share: the form (2 D flops per pair) on the
    FP32 units at D <= 8, on the tensor cores above; one transcendental per
    pair on the special-function units; each input read once and each
    output written once; and the signal columns (2 flops per pair and
    column, one more column for the row sums of a normalised direct
    product) on whichever unit gives the least such time.
    """
    cols = e + (1 if normalize and which == "direct" else 0)
    pairs = float(n) * m
    passes, peak = TENSOR_CORE_FORM[tier]
    shares = {"f32 FMA": 0.0, "tensor cores": 0.0,
              "special-function units": pairs / sfu_rate,
              "memory": ((n + m) * d + m * e + n * e) * 4 / PEAK_BYTES}
    if d <= 8:
        shares["f32 FMA"] += 2.0 * pairs * d / PEAK_F32_FLOPS
    else:
        shares["tensor cores"] += 2.0 * pairs * d * passes / peak
    signal = {"tensor cores": 2.0 * pairs * cols * passes / peak}
    if tier != "bfloat16":
        signal["f32 FMA"] = 2.0 * pairs * cols / PEAK_F32_FLOPS
    options = []
    for unit, seconds in signal.items():
        terms = dict(shares)
        terms[unit] += seconds
        engine = max(terms, key=terms.get)
        options.append((terms[engine], engine))
    least, engine = min(options)
    return (least * 1e3, "bytes" if engine == "memory" else "operations",
            engine)


def special_function_rate(sm_count, max_clock_mhz):
    """Special-function operations per second at the maximum clock."""
    return SFU_PER_CLOCK_PER_SM * sm_count * max_clock_mhz * 1e6


def card_facts(index):
    """(name, maximum SM clock in MHz, power limit in W) of card `index`
    from nvidia-smi, or None where it cannot be read."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "-i", str(index),
             "--query-gpu=name,clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0 or not proc.stdout.strip():
        return None
    name, clock, limit = (part.strip() for part in
                          proc.stdout.strip().splitlines()[0].split(","))
    return name, float(clock), float(limit)


def query_bound_ms(config, ranks, sfu_rate):
    """The least ms of one query's kernel work on one of `ranks` cards:
    its share of the targets against every source."""
    n = -(-config["n_targets"] // ranks)
    return bound_ms(n, config["n_sources"], config["dimension"],
                    config["signal_columns"], launch_kind(config),
                    config["normalize_rows"], config["precision"],
                    sfu_rate)[0]


def launch_kind(config):
    """"flash" for row-normalised kernels with a log form (the base-2
    online softmax), else "direct"."""
    flash = config["normalize_rows"] and config["kernel"] in (
        "gaussian", "absolute-exponential", "exponential")
    return "flash" if flash else "direct"
