"""Training samples a second: the batch times every step of the window,
over the window from its start to the end of its last step (its metrics
read to the host)."""


def read(record):
    if record["kind"] != "train":
        return None
    return record["units"] * record["samples_per_unit"] / record["window_s"]
