"""Host milliseconds per admit round (claiming slots, prefill launches, the
first tokens' download), from the scheduler's own counters."""
NAME, UNIT, BETTER = "admit_ms", "ms", "lower"
LAYER, SOURCE, MOVES = "scheduler", "program_counter", "tpot_p90_ms"


def read(data):
    s = data["stats"]
    return 1e3 * s["admit_time_s"] / s["admit_rounds"] if s.get("admit_rounds") else None
