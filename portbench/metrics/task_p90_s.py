"""90th percentile, over every task finished inside the window, of the
seconds from the task entering the worker to its finish."""
import statistics


def read(ctx):
    latencies = [finished - entered for entered, finished in ctx.tasks]
    if len(latencies) < 2:
        return None
    return statistics.quantiles(latencies, n=10, method="inclusive")[8]
