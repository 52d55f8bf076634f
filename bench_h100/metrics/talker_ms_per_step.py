"""Device ms a captured frame step spends in the talker step (its decode
layers and the codec head, from the step's start stamp to its end stamp),
the mean over every stamped step of the window's recording replays: the
program's ``talker_step`` device parts (``TRACE.device_spans``)."""
from tracer import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "talker_step")
