"""The int8 block-sparse kernels' share of their roofline inside chunked
prefill launches, counted as ``int8_decode_roofline`` counts decode's."""
NAME, UNIT, BETTER = "int8_prefill_roofline", "%", "higher"
LAYER, SOURCE, MOVES = "kernels", "device_trace", "tpot_p90_ms"


def read(data):
    p, d = data.get("profile") or {}, (data.get("spans") or {}).get("prefill") or {}
    if not p.get("int8_prefill_s") or not d.get("traced_int8_bound_s"):
        return None
    return 100.0 * d["traced_int8_bound_s"] / p["int8_prefill_s"]
