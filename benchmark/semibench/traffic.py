"""The one generator of the benchmark's traffic: the standard normals of
each repetition's coherent-state draw, i.i.d. from --seed and the
repetition's index, on the device, at the task's batch size. Every seed
gives the same sizes; only the draws differ."""

import numpy as np
import torch

WINDOW, WARMUP = 0, 1


def stream_seed(seed, stream, index=0):
    """A 63-bit generator seed for repetition `index` of `stream` (the
    window's or the warm-up's) of run seed `seed` (any whole number)."""
    entropy = [int(seed) % 2 ** 64, stream, index]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return int(state[0]) % 2 ** 63


def normals(task, seed, stream, index, rank, device):
    """(batch_size, 2 rank) float64 standard normals of one repetition."""
    n = int(task["batch_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream, index))
    method = task.get("sampling", "pseudo")
    if method != "pseudo":
        raise ValueError(f"the benchmark's traffic has no sampling "
                         f"{method!r}")
    return torch.randn((n, 2 * rank), generator=gen, dtype=torch.float64,
                       device=device)
