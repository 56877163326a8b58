"""Questions answered per second of the traced window, on the host clock:
every question of every call over the window's time (the entry's
``qps``, reported per layer where the host's speed makes it too unsteady
for a bound)."""


def read(run):
    if not run.questions or run.window_s <= 0:
        return None
    return run.questions / run.window_s
