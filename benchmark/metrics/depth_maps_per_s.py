"""Depth maps completed a second: every request of the window, over the
window from its start to the end of its last request."""


def read(record):
    if record["kind"] != "serve":
        return None
    return record["units"] * record["samples_per_unit"] / record["window_s"]
