"""Least work of one HK step of the separable AS model, per batch of n
trajectories of d modes at float64 (8 bytes a number).

Bytes: every byte of the state read once and written once a step: q, p
and the four diagonal monodromy planes (6 n d), the action S, the sign
tracker's previous C^2 (complex) and its sign (4 n); plus the batch
constants the observables read once (the two overlap exponents and the
complex NAC factor, 4 n). The per-step sums written are negligible.

Operations: a lower count of the arithmetic of one RK4 step with the
monodromy and the observables, per trajectory and mode, transcendental
functions counted as one operation each: the Morse value, gradient and
Hessian diagonal at four stages (4 x 14), the stage arguments and the RK4
sums of q, p and S (4 x 4 + 8), the 2x2 monodromy's four stages on two
columns (4 x 8 + 8), the prefactor's mode term with its log and angle
(10) and the two overlap exponents and NAC forms (20): 150."""

BYTES_PER_NUMBER = 8
STATE_NUMBERS_PER_MODE = 6        # q, p, Mqq, Mqp, Mpq, Mpp
STATE_NUMBERS_PER_TRAJ = 4        # S, previous C^2 (2), sign
CONSTANT_NUMBERS_PER_TRAJ = 4     # obs_re, obs_im, nacq (2)
FLOPS_PER_MODE = 150


def _dims(task):
    n = int(task["batch_size"])
    d = int(task["potential"]["model"]["num_modes"])
    return n, d


def step(task):
    """{"bytes", "flops": {type: operations}} of one step of the whole
    batch."""
    n, d = _dims(task)
    state = n * (STATE_NUMBERS_PER_MODE * d + STATE_NUMBERS_PER_TRAJ)
    return {"bytes": BYTES_PER_NUMBER * (2 * state
                                         + n * CONSTANT_NUMBERS_PER_TRAJ),
            "flops": {"float64": FLOPS_PER_MODE * n * d}}
