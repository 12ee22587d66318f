def _complete_jobs(s):
    return s


def apply_budget(s, const):
    return s
