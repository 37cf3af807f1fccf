"""The comparison that decides `correct`.

Every answer the window returned is kept at the checked rows (the same
rows in every answer, drawn from the seed) and compared there with the
plain reference's float64 product for its signal.  The differences are
measured against the size of the terms summed: the reference's product
of the kernel values with |signal| (for a row-normalised product, its
weighted mean of |signal|), whose root mean square over the checked rows
is the answer's `scale`.  The product itself would not do: a signal's
terms cancel, by an amount that changes from signal to signal, while
float32 rounding follows the terms.  Three numbers, each the worst over
the answers:

- `err_max`: the largest |answer - reference| at the checked rows, over
  the scale;
- `err_rms`: the root mean square of answer - reference over the scale;
- `repeat_gap`: the largest |answer - first answer to the same signal|:
  the engine is deterministic, so its limit is 0.

An answer fails when one of its numbers passes its limit or is not
finite; the run is correct when none failed and there was at least one.
"""

from __future__ import annotations

import math

import numpy as np

NAMES = ("err_max", "err_rms", "repeat_gap")


def answer_numbers(answer, reference, magnitude, first):
    """The three numbers of one answer (R, E) against its reference (R, E),
    the size of its terms (R, E) and the first answer to its signal."""
    scale = math.sqrt(float(np.mean(magnitude * magnitude)))
    scale = scale if scale > 0 else 1.0
    diff = answer - reference
    return {"err_max": float(np.max(np.abs(diff))) / scale,
            "err_rms": math.sqrt(float(np.mean(diff * diff))) / scale,
            "repeat_gap": float(np.max(np.abs(answer - first)))}


def judge(answers, signal_ids, reference, magnitude, limits):
    """(correct, failed, numbers) of the answers (Q, R, E) to the pool
    signals `signal_ids` (Q,), with `reference` and `magnitude` (S, R, E):
    the plain product of each signal and of its absolute value.  `numbers`
    maps each name to its worst value (None where not finite)."""
    worst = dict.fromkeys(NAMES, 0.0)
    failed = 0
    firsts = {}
    for answer, s in zip(answers, signal_ids):
        first = firsts.setdefault(int(s), answer)
        numbers = answer_numbers(answer, reference[int(s)],
                                 magnitude[int(s)], first)
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
    correct = failed == 0 and len(answers) > 0
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
