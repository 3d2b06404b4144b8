"""The host's time in each ``window_step`` call (no synchronize inside:
the enqueue of the forward, backward and optimizer), mean over the
measured window, ms."""

from portbench.harness.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "window_step")
