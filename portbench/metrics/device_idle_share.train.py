"""The share of the traced stretch of training steps in which no operation ran
on the device."""


def read(view):
    return None if view.trace is None else view.trace.idle_pct()
