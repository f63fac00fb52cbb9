"""Share of the traced training slice in which no kernel ran: 1 - the union
of the kernels' intervals over the slice's span."""


def read(m: dict):
    tr = m.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
