def ration_rows(s, const, enabled):
    return s
