"""Device ms a captured frame step spends from the predictor frame's start
to the talker step's start (the predictor's codebooks and the glue before
the talker), the mean over every stamped step of the window's recording
replays: the program's ``predictor_frame`` device parts
(``TRACE.device_spans``, stamps on the host's clock)."""
from tracer import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "predictor_frame")
