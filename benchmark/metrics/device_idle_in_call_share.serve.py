"""% of the stamped stretch in which the device waited on the host inside a
call: from a call's entry to its first stamp, and after each stamp that
closes a stage until the call's next one (`utils/profiling.Tracer.export`)."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "serve", "device_idle_in_call_share")
