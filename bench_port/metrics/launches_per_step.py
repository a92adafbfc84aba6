"""launches_per_step (launches/step, layer "ops wrappers"): the device's
kernel launches in the window over its training steps; copies and fills
are not counted."""


def read(view):
    if view.steps == 0:
        return None
    return len(view.kernels) / view.steps
