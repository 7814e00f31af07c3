"""Trajectories x steps of every repetition that finished in the window,
over the window's whole wall (sampling, the time loop, reduction and
accumulation included). Host clock."""


def read(run):
    if run.window_s <= 0 or not run.done:
        return None
    return run.traj_steps / run.window_s
