"""Device milliseconds of chunked-prefill launches per 1,000 real prompt
tokens (padding and dummy rows not counted as tokens)."""
NAME, UNIT, BETTER = "prefill_ms_per_ktok", "ms/ktok", "lower"
LAYER, SOURCE, MOVES = "engine", "program_span", "tpot_p90_ms"


def read(data):
    p = (data.get("spans") or {}).get("prefill") or {}
    if not p.get("real_tokens") or not p.get("device_ms"):
        return None
    return p["device_ms"] / (p["real_tokens"] / 1e3)
