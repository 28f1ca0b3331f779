"""The numbers that decide `correct`, each against its limit
(`limits/<cell>.json`; `PERF.md` gives the readings each was set from).

Training (the first steps of the timed path against the reference's):
- `loss_gap`: the worst relative gap of a step's loss;
- `grad_gap`: the worst leaf's gap between the norms of the first
  gradient (the program's worked out from AdamW's first moment after one
  step), against the reference's norm of that leaf or of the median
  leaf, whichever is larger;
- `change_gap`: the same of the parameters' change over the checked
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

Serving: `logit_gap`, the widest gap by which a served token's logit
lies below the reference's best at its position.
"""

from __future__ import annotations

import statistics

# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of `change_gap`
QUIET_LEAF = 1e-3


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """{unit: gap of its norms, against its reference norm or the median
    unit's, whichever is larger}."""
    leaves = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves}


def _moving(ref: dict) -> list:
    med_g = statistics.median(ref["grad1"].values())
    return [n for n, g in ref["grad1"].items() if g >= QUIET_LEAF * med_g]


def worst_units(prog: dict, ref: dict) -> dict:
    """The unit that sets `grad_gap` and `change_gap`."""
    return {"grad_gap": _argmax(leaf_gaps(prog["grad1"], ref["grad1"])),
            "change_gap": _argmax(leaf_gaps(prog["change"], ref["change"],
                                            _moving(ref)))}


def _argmax(d: dict) -> str:
    return max(d, key=d.get)


def train_readings(prog: dict, ref: dict) -> dict:
    """prog and ref: {"losses": [...], "grad1": {leaf: norm}, "change":
    {leaf: norm}}."""
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": max(leaf_gaps(prog["grad1"], ref["grad1"]).values()),
        "change_gap": max(leaf_gaps(prog["change"], ref["change"],
                                    _moving(ref)).values()),
    }


def judge(readings: dict, limits: dict) -> dict:
    """{name: [reading, limit]} for every limited number (a reading that
    is not a finite number fails)."""
    out = {}
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and value == value and value <= limit
        out[name] = [value, limit, ok]
    return out
