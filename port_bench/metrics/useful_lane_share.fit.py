"""Real-candidate lanes over the lanes the round runs, in %: the padding of
the last piece of lanes is work that scores no candidate (counted by the
harness from the lanes it hands to ``prune_fit.batched``)."""


def read(ctx):
    c = ctx.counters
    if not c.get("lanes_per_round"):
        return None
    return 100.0 * c["useful_lanes_per_round"] / c["lanes_per_round"]
