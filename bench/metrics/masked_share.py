"""Share of decode slot-steps run masked (a slot empty, prefilling or done)
against all slot-steps run, from the scheduler's own counters."""
NAME, UNIT, BETTER = "masked_share", "%", "lower"
LAYER, SOURCE, MOVES = "scheduler", "program_counter", "tpot_p90_ms"


def read(data):
    s = data["stats"]
    total = s.get("slot_steps_live", 0) + s.get("slot_steps_masked", 0)
    return 100.0 * s["slot_steps_masked"] / total if total else None
