"""The decode steps' share of the card's peak: Σ over steps of the step's
problem at its roofline (``roofline.decode_step``: live rows only, real
context lengths) over the host-clock time the decode segments took."""
NAME, UNIT, BETTER = "mfu.decode", "%", "higher"
LAYER, SOURCE, MOVES = "model step", "host_clock", "tpot_p90_ms"


def read(data):
    d = (data.get("spans") or {}).get("decode") or {}
    return 100.0 * d["roofline_s"] / d["host_s"] if d.get("host_s") and d.get("steps") else None
