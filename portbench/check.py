"""The comparison that decides `correct`.

The cell's task keeps what it checks of every answer the window returned
and says, for each, what was got, what was wanted and the size of the
terms summed, at the checked rows (tasks/<task>.py `compared`).  For the
product: the answer at the checked rows (the same rows in every answer,
drawn from the seed), the plain reference's float64 product for its
signal, and the reference's product of the kernel values with |signal|
(for a row-normalised product, its weighted mean of |signal|), whose root
mean square over the checked rows is the answer's `scale`.  The product
itself would not do: a signal's terms cancel, by an amount that changes
from signal to signal, while float32 rounding follows the terms.  Three
numbers, each the worst over the answers:

- `err_max`: the largest |got - wanted| at the checked rows, over the
  scale;
- `err_rms`: the root mean square of got - wanted over the scale;
- `repeat_gap`: the largest |got - first got for the same signal|: the
  engine is deterministic, so its limit is 0.

An answer fails when one of its numbers passes its limit or is not
finite; the run is correct when none failed and there was at least one.
"""

from __future__ import annotations

import math

import numpy as np

NAMES = ("err_max", "err_rms", "repeat_gap")


def answer_numbers(got, wanted, size, first):
    """The three numbers of one answer: what was got (R, E) against what
    was wanted (R, E), the size of its terms (R, E) and what was got
    first for its signal."""
    scale = math.sqrt(float(np.mean(size * size)))
    scale = scale if scale > 0 else 1.0
    diff = got - wanted
    return {"err_max": float(np.max(np.abs(diff))) / scale,
            "err_rms": math.sqrt(float(np.mean(diff * diff))) / scale,
            "repeat_gap": float(np.max(np.abs(got - first)))}


def judge(compared, signal_ids, limits):
    """(correct, failed, numbers) of the answers whose (got, wanted, size)
    are `compared`, to the signals `signal_ids`.  `numbers` maps each name
    to its worst value (None where not finite)."""
    worst = dict.fromkeys(NAMES, 0.0)
    failed = attempted = 0
    firsts = {}
    for (got, wanted, size), s in zip(compared, signal_ids):
        attempted += 1
        first = firsts.setdefault(int(s), got)
        numbers = answer_numbers(got, wanted, size, first)
        bad = False
        for name, value in numbers.items():
            if not math.isfinite(value):
                worst[name] = None
                bad = True
                continue
            if worst[name] is not None:
                worst[name] = max(worst[name], value)
            bad |= value > limits[name]
        failed += bad
    correct = failed == 0 and attempted > 0
    return correct, failed, worst


def lines(numbers, limits):
    """One plain line per number: its name, value and limit."""
    return [f"check {name} {_text(numbers[name])} limit {limits[name]!r}"
            for name in NAMES]


def summary(numbers, limits):
    """The result line's last key: each number beside its limit."""
    return {name: {"value": numbers[name], "limit": limits[name]}
            for name in NAMES}


def _text(value):
    return "not-finite" if value is None else repr(value)
