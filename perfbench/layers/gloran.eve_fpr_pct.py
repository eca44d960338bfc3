"""gloran.eve_fpr_pct: the share of valid entries that GLORAN's EVE
estimator failed to clear on the point-lookup path, over the window,
in %: the paper's epsilon.  From the counters ``engine.stats()`` sums
over the shards (``gloran``: ``lookup_probes``, the found entries sent
to validity; ``eve_maybe``, those EVE could not prove valid;
``deleted``, those the index found deleted).  EVE has no false
negatives, so every deleted entry is among the maybes.  None without a
valid probe."""


def read(w):
    probes = w.delta("gloran", "lookup_probes")
    maybe = w.delta("gloran", "eve_maybe")
    dead = w.delta("gloran", "deleted")
    if probes - dead <= 0:
        return None
    return 100 * (maybe - dead) / (probes - dead)
