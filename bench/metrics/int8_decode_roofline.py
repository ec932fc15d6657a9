"""The int8 block-sparse kernels' share of their roofline inside decode
replays: Σ bound of the launches (each projection at the rows as launched,
``roofline.int8_launch``) over Σ their kernel time in the profiled slice."""
NAME, UNIT, BETTER = "int8_decode_roofline", "%", "higher"
LAYER, SOURCE, MOVES = "kernels", "device_trace", "tpot_p90_ms"


def read(data):
    p, d = data.get("profile") or {}, (data.get("spans") or {}).get("decode") or {}
    if not p.get("int8_decode_s") or not d.get("traced_int8_bound_s"):
        return None
    return 100.0 * d["traced_int8_bound_s"] / p["int8_decode_s"]
