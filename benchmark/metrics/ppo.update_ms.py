"""ppo.update_ms: the port's own `timings["update_ms"]` (its host clock,
the card synchronized), mean over the window's iterations."""
TIMINGS = True


def read(rec):
    t = [x["update_ms"] for x in rec.timings or [] if "update_ms" in x]
    return sum(t) / len(t) if t else None
