"""The 95th percentile of every request of the window, host clock from
the call to its numpy answer."""
import statistics


def read(record):
    if record["kind"] != "serve" or len(record["latencies_s"]) < 2:
        return None
    return 1e3 * statistics.quantiles(record["latencies_s"], n=100, method="inclusive")[94]
