"""`device_idle`: the share of the traced window in which no operation ran
on the card (`tracing.py`: each launch busy from its first operation to
its last), in percent."""


def read(record):
    trace = record.get("trace")
    if not trace or not trace["device_events"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / record["window_s"])
