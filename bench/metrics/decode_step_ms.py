"""Device milliseconds per decode step: CUDA events around each decode
segment's replays, over the steps (rounds) they ran."""
NAME, UNIT, BETTER = "decode_step_ms", "ms", "lower"
LAYER, SOURCE, MOVES = "engine", "program_span", "tpot_p90_ms"


def read(data):
    d = (data.get("spans") or {}).get("decode") or {}
    return d["device_ms"] / d["steps"] if d.get("steps") and d.get("device_ms") else None
