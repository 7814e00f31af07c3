"""The table of published peaks (`peaks.json`) and the least time of a
piece of work on a card."""

import json
import pathlib

TABLE = pathlib.Path(__file__).resolve().parents[1] / "peaks.json"


def of(device):
    """The peaks of the card `device`, or None for a card not in the
    table (or no card)."""
    import torch

    if device.type != "cuda":
        return None
    with open(TABLE) as f:
        return json.load(f)["cards"].get(torch.cuda.get_device_name(device))


def _seconds(work, peak):
    """(bytes / bandwidth, the sum of the operations of each type over
    the peak rate of that type) of `work` = {"bytes", "flops": {type:
    operations}}."""
    return (work["bytes"] / peak["bytes_per_s"],
            sum(f / peak["flops_per_s"][t] for t, f in work["flops"].items()))


def least_seconds(work, peak):
    """The least time of `work` on the card: the larger of the two."""
    return max(_seconds(work, peak))
