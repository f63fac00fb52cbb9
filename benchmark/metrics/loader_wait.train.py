"""Share of the training window the step loop waited for the loader's next
batch, in the feed around the loader's iterator (host clock)."""


def read(m: dict):
    return 100.0 * m["loader_wait_s"] / m["window_s"]
