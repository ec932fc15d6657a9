"""Share of the profiled slice in which no operation ran on the card: one
minus the union of the device events' intervals over the slice."""
NAME, UNIT, BETTER = "idle_share", "%", "lower"
LAYER, SOURCE, MOVES = "device", "device_trace", "tok_s"


def read(data):
    p = data.get("profile") or {}
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"]) if p.get("window_s") else None
