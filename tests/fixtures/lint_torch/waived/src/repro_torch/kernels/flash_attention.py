LAUNCHES = {"attend": 0}


# spars-lint: ignore[PL004] a benchmark's direct entry, reached after the checks
def attend_variant(q):
    LAUNCHES["attend"] += 1
    return q
