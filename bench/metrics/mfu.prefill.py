"""The prefill launches' share of the card's peak: Σ of each launch's
problem at its roofline (``roofline.prefill_chunk``: real tokens only) over
the host-clock time the launches took."""
NAME, UNIT, BETTER = "mfu.prefill", "%", "higher"
LAYER, SOURCE, MOVES = "model step", "host_clock", "tpot_p90_ms"


def read(data):
    p = (data.get("spans") or {}).get("prefill") or {}
    return 100.0 * p["roofline_s"] / p["host_s"] if p.get("host_s") and p.get("calls") else None
